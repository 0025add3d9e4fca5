#!/usr/bin/env python3
"""Where K2's time goes on one CUDA card, at chip_smoke.py's training shape
(B=64, T=1000, N=30, S=50, fp32, ragged lengths, the same seeded data).

    python3 scripts/k2_diag.py [--variants]

Prints one JSON line per part:
  split:    each route's CUDA-event median through the wrapper
            (``_bwd_kernel``) and through the launch alone, 20 calls issued
            back to back (the host's enqueue hidden), and the host's own
            µs a call; routes in turns (warp, block, warp, block);
  chunks:   the warp route's time and its three kernels' device times
            (profiler) for several numbers of posterior blocks
            (``POST_BLOCKS``);
  variants: with --variants, the warp route built from patched copies of
            ``csrc/asg_bwd.cu`` (in the ignored build directory), each
            launched directly and timed with CUDA events: the chain without
            its per-step row stores (only the last row stored), with one of
            its two warps idle, and with E in registers where a lane holds
            one label.  The patched kernels' outputs are not checked: they
            are timing probes.
Run from the repository root on a machine with the CUDA toolkit.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from torch_asg_tpu_torch.ops.kernels import _build  # noqa: E402
from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak  # noqa: E402
from torch_asg_tpu_torch.ops.kernels import common as kc  # noqa: E402

# E in registers for a lane that holds one label: each lane keeps its column
# of the padded E^T (32 words) and reads only the row x from shared memory.
E_REGS = """
template <typename T>
__device__ __forceinline__ void contract_regs(const T* __restrict__ x,
                                              const T (&ecol)[32], T (&sum)[1]) {
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    T xv[4];
    load4(x + j, xv);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += xv[q] * ecol[j + q];
  }
  sum[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}
"""

CHAIN_STORE = "      store_row(s_out + ((size_t)t * batch + b) * n, n, lane, s);\n"
FAC_STORE = "      store_row(qa_out + ((size_t)t * batch + b) * s, s, lane, qa);\n"
FAC_CALL = "    fac_alpha_warp<T, RS>(al, self_t, next_t, qa_out, L, b, batch, s, lane);\n"
FCC_CALL = ("    fcc_alpha_warp<T, RN>(em, et_glob, reinterpret_cast<T*>(smem_raw), s_out, L, b,\n"
            "                          batch, n, lane);\n")
CONTRACT = "      contract_row<T, RN>(xr, e, lane, s);\n"
E_LOADED = "  __syncwarp();  // E is in place\n"
PHASE1 = "// Phase 1, the FCC warp of an element"


def variant_sources(src):
    """{name: patched source}; every patch must apply exactly once."""
    def patch(text, pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"patch does not apply: {old!r}")
            text = text.replace(old, new)
        return text

    last_only = "      if (t == L - 1)\n"
    return {
        "baseline": src,
        "no_row_stores": patch(src, [(CHAIN_STORE, last_only + CHAIN_STORE),
                                     (FAC_STORE, last_only + FAC_STORE)]),
        "fcc_warp_alone": patch(src, [(FAC_CALL, "    ;\n")]),
        "fac_warp_alone": patch(src, [(FCC_CALL, "    ;\n")]),
        "e_in_registers_rn1": patch(src, [
            (PHASE1, E_REGS + PHASE1),
            (E_LOADED, E_LOADED + "  T ecol[RN == 1 ? 32 : 1];\n  if constexpr (RN == 1) {\n"
                       "#pragma unroll\n    for (int j = 0; j < 32; ++j) ecol[j] = e[j * 32 + lane];\n"
                       "  }\n"),
            (CONTRACT, "      if constexpr (RN == 1) contract_regs<T>(xr, ecol, s);\n"
                       "      else contract_row<T, RN>(xr, e, lane, s);\n"),
        ]),
    }


def build_variants():
    """Compile every variant at once into the build directory; {name: CDLL}."""
    src = (_build.CSRC / "asg_bwd.cu").read_text()
    out_dir = _build.BUILD / "k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variant_sources(src).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def training_case(dev):
    rng = np.random.default_rng(c.SEED)
    args = c.k1_args(c.lattice_case(rng, dev, torch.float32, c.B, c.T, c.N, c.S,
                                    (500, 1000), (10, 50)))
    pb, qb, _, _ = ak._fwd_store_kernel(*args)
    g_full = torch.as_tensor(rng.uniform(0.5, 1.5, size=c.B), dtype=torch.float32, device=dev)
    g_fac = -torch.as_tensor(rng.uniform(0.5, 1.5, size=c.B), dtype=torch.float32, device=dev)
    return args[:6] + (pb, qb, g_full, g_fac)


def split(bargs):
    li = bargs[5].to(torch.int32).contiguous()
    res = {}
    for route in ("warp", "block", "warp", "block"):
        r = res.setdefault(route, {"wrapper_ms": [], "launch_ms": [], "batched20_ms": [],
                                   "host_us": []})
        r["wrapper_ms"].append(c.time_ms(lambda: ak._bwd_kernel(*bargs, route=route)))
        outs = ak._bwd_kernel(*bargs, route=route)
        r["launch_ms"].append(c.time_ms(
            lambda: ak._launch_bwd(route, *bargs[:5], li, *bargs[6:], outs)))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            ak._bwd_kernel(*bargs, route=route)
        end.record()
        end.synchronize()
        r["batched20_ms"].append(start.elapsed_time(end) / 20)
        t0 = time.perf_counter()
        for _ in range(20):
            ak._bwd_kernel(*bargs, route=route)
        r["host_us"].append((time.perf_counter() - t0) / 20 * 1e6)
        torch.cuda.synchronize()
    return res


def chunks(bargs):
    out, orig = {}, kc.POST_BLOCKS
    try:
        for blocks in (528, 1056, 2112, 4224):
            kc.POST_BLOCKS = blocks
            prof = c.device_profile(lambda: ak._bwd_kernel(*bargs, route="warp"),
                                    c.K2_WARP_PHASES)
            out[blocks] = {"chunk": kc.post_chunk(c.T, c.B),
                           "ms": c.time_ms(lambda: ak._bwd_kernel(*bargs, route="warp")),
                           "phase_ms": prof["phase_ms"]}
    finally:
        kc.POST_BLOCKS = orig
    return out


def variants(bargs):
    e, self_t, next_t, inputs, aligned, li, pb, qb, g_full, g_fac = bargs
    li = li.to(torch.int32).contiguous()
    t_total, batch, n = inputs.shape
    s = aligned.shape[2]
    chunk = kc.post_chunk(t_total, batch)
    nparts = batch * -(-t_total // chunk)
    dev, dt = inputs.device, inputs.dtype
    outs = [torch.zeros((t_total, batch, n), dtype=dt, device=dev),
            torch.zeros((t_total, batch, s), dtype=dt, device=dev),
            torch.empty((n, n), dtype=dt, device=dev),
            torch.empty((batch, s), dtype=dt, device=dev),
            torch.empty((batch, s), dtype=dt, device=dev),
            torch.empty((t_total, batch, n), dtype=dt, device=dev),
            torch.empty((t_total, batch, s), dtype=dt, device=dev),
            torch.empty((nparts, n, n), dtype=dt, device=dev),
            torch.empty((2, nparts, s), dtype=dt, device=dev)]
    ptrs = [inputs, aligned, e, e.T.contiguous(), self_t, next_t, li, pb, qb, g_full, g_fac,
            *outs]
    out = {}
    for name, lib in build_variants().items():
        fn = lib.asg_bwd_warp_f32
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            err = fn(*[ctypes.c_void_p(p.data_ptr()) for p in ptrs], t_total, batch, n, s,
                     chunk, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            c.check(err == 0, f"variant {name}: cudaError_t {err}")

        out[name] = c.time_ms(run)
    return out


def main():
    c.check(torch.cuda.is_available(), "k2_diag.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build_all()
    bargs = training_case(dev)
    c.emit({"card": torch.cuda.get_device_name(0), "split": split(bargs)})
    c.emit({"chunks": chunks(bargs)})
    if "--variants" in sys.argv[1:]:
        c.emit({"variants": variants(bargs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The per-lattice tier's warp routes (K3, K4, K5 and K7) on one CUDA card,
for bring-up and for reading what the compiler made of them.

    python3 scripts/fcc_diag.py [--sass] [--check K3,K5] [--profiler]

Builds the kernels first (``_build.build_all``), then:
  --sass:  disassembles the fp32 instances of the warp-route kernels of
           K3, K4 and K5 (``csrc/fcc.cu``) and K7 (``csrc/fac.cu``)
           (``cuobjdump -sass`` of the built libraries) into the
           ignored ``build/sass/<kernel>.sass`` beside the libraries and
           prints, for each, its
           registers and spills (``-Xptxas -v``) and its count of each kind
           of instruction that sets a chain's step: FFMA/FMUL/FADD, shared
           loads and stores, MUFU (exp, log, reciprocal), shuffles, REDUX,
           warp and block barriers, global loads and stores;
  --check: ``chip_smoke.check_lattice_kernels`` restricted to the named
           kernels (each on both routes in every case, against its plain
           version), printing the kernels' lines;
  --profiler: what torch.profiler records of K3's warp route (its chain
           and log-pass kernels, one launch of each a call) in sessions of
           1 and of 5 calls, right after a first session that traced K1
           and again after two idle minutes: the evidence for taking each
           of ``chip_smoke.py``'s profiles in a process of its own.
Run from the repository root on a machine with the CUDA toolkit.
"""

import collections
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from torch_asg_tpu_torch.ops.kernels import _build  # noqa: E402

# the warp-route kernels, by library
KERNELS = {"fcc": ("fcc_fwd_warp_kernel", "fcc_fwd_log_kernel", "fcc_beta_warp_kernel",
                   "fcc_beta_log_kernel", "fcc_bwd_post_kernel", "fcc_bwd_sums_kernel"),
           "fac": ("fac_beta_warp_kernel",)}
KINDS = {"fp_arith": r"^(FFMA|FMUL|FADD|DFMA|DMUL|DADD)", "lds": r"^LDS", "sts": r"^STS",
         "mufu": r"^MUFU", "shfl": r"^SHFL", "redux": r"^REDUX", "warpsync": r"^WARPSYNC",
         "bar": r"^BAR", "ldg": r"^LDG", "stg": r"^STG", "branch": r"^(BRA|BSSY|BSYNC)"}


def sass(lib, kernels):
    """{mangled kernel name: its SASS lines} for the fp32 instances of
    ``kernels`` in the library ``lib``."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k + "If" in m.group(1) for k in kernels) else None
            if name:
                out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.split("*/", 1)[1].strip().rstrip(";").strip())
    return out


def plain_profile(fn, calls):
    """{kernel name cut to 40 characters: launches seen} in one profiler
    session of ``calls`` calls of ``fn``, with no warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def profiler_probe(dev):
    from torch_asg_tpu_torch.ops.kernels import asg_kernels as ak
    from torch_asg_tpu_torch.ops.kernels import fcc_kernels as fk

    rng = np.random.default_rng(c.SEED)
    k1 = c.k1_args(c.lattice_case(rng, dev, torch.float32, 8, 200, c.N, c.S, (100, 200),
                                  (10, c.S)))
    trans, inputs, _, li, _ = c.lattice_case(rng, dev, torch.float32, c.B, c.T, c.N, c.S,
                                             (500, 1000), (10, c.S))
    args = fk._prepare(trans, inputs, li)

    def k3():
        return fk.fcc_fwd_pallas(*args, route="warp")

    k3()
    out = {"k1_session": plain_profile(lambda: ak._fwd_scores_kernel(*k1), 1)}
    for wait_s in (0, 120):
        time.sleep(wait_s)
        for calls in (1, 5):
            out[f"k3_session_{calls}_calls_after_{wait_s}_s"] = plain_profile(k3, calls)
    c.emit({"profiler": out})


def main(argv):
    c.check(torch.cuda.is_available(), "fcc_diag.py needs a CUDA card")
    libs = _build.build_all()
    c.emit({"card": torch.cuda.get_device_name(0)})
    if "--sass" in argv:
        out_dir = _build.BUILD / "sass"
        out_dir.mkdir(parents=True, exist_ok=True)
        listings, usage = {}, {}
        for lib, kernels in KERNELS.items():
            log = libs[lib].with_suffix(".log").read_text()
            for marker in kernels:
                usage.update(c.spill_bytes(log, marker + "If"))
            listings.update(sass(libs[lib], kernels))
        for name, lines in listings.items():
            (out_dir / f"{name[:120]}.sass").write_text("\n".join(lines) + "\n")
            ops = [ln.split()[0] if not ln.startswith("@") else ln.split()[1] for ln in lines
                   if ln]
            counts = collections.Counter()
            for op in ops:
                for kind, pattern in KINDS.items():
                    if re.match(pattern, op):
                        counts[kind] += 1
            c.emit({"kernel": name, "instructions": len(ops), "spill_bytes": usage.get(name),
                    "by_kind": dict(counts)})
    if "--profiler" in argv:
        profiler_probe(torch.device("cuda", 0))
    if "--check" in argv:
        only = tuple(argv[argv.index("--check") + 1].split(","))
        out = c.check_lattice_kernels(np.random.default_rng([c.SEED, 4]),
                                      torch.device("cuda", 0), only=only)
        for k in out:
            c.emit({"phase": "kernel", **k})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

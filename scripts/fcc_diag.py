#!/usr/bin/env python3
"""The warp routes of the per-lattice tier (K3-K7), of the alignment
forward (K12) and of the two backtraces (K11, K13) on one CUDA card, for
bring-up and for reading what the compiler made of them.

    python3 scripts/fcc_diag.py [--sass] [--same-sass PARENT_ROOT] [--check K3,K5]
                                [--k6-variants] [--bt-variants] [--profiler]

Builds the kernels first (``_build.build_all``), then:
  --sass:  disassembles the fp32 instances of the warp-route kernels of
           K3, K4 and K5 (``csrc/fcc.cu``), K6 and K7 (``csrc/fac.cu``) and
           K12 (``csrc/viterbi.cu``), and every instance of K11's and K13's
           (``csrc/viterbi.cu``; int rows) (``cuobjdump -sass`` of the built
           libraries) into the ignored ``build/sass/<kernel>.sass`` beside
           the libraries and prints, for each, its
           registers and spills (``-Xptxas -v``) and its count of each kind
           of instruction that sets a chain's step: FFMA/FMUL/FADD, shared
           loads and stores, MUFU (exp, log, reciprocal), shuffles, REDUX,
           warp and block barriers, global loads and stores;
  --same-sass PARENT_ROOT: compiles every ``csrc/*.cu`` of this checkout
           and of the checkout at PARENT_ROOT to a cubin (the build's
           target and optimisation flags), disassembles both, and prints,
           for each source, the kernels whose SASS is the same, those whose
           SASS differs and those only one checkout has (names compared
           with the anonymous namespace's per-file tag cut out);
  --k6-variants: K6's warp route at the training shape built from this
           checkout's ``csrc/fac.cu`` and from patched copies of it (in the
           ignored build directory), launched directly and timed with CUDA
           events in turns: the block sweep, 2 and 8 frames a block in
           place of 4 (``block_2``, ``block_8``; these and the baseline in
           fp32 and fp64); in fp32, the chain's exp and log as expf and
           logf (``accurate_exp_log``) and as __expf and __logf
           (``intrinsic_exp_log``) in place of the SFU's flushing
           ex2.approx.ftz and lg2.approx.ftz, and two timing probes whose
           outputs are wrong (``probe_*``: no refill of the ring of bands,
           only the last row stored); each variant's largest error against
           the sequential plain version is printed beside its times;
  --bt-variants: K11's and K13's warp routes at the serving shape built
           from this checkout's ``csrc/viterbi.cu`` and from patched copies
           of it (BT_VARIANTS: stores batched 32 frames an instruction,
           each word shuffled before the select, a chain of one shuffle
           and a second shuffle for the stored value, and the first
           design's pieces), launched directly and timed with CUDA events in
           turns, each checked bit for bit against its plain version, with
           each copy's spill bytes;
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
import ctypes
import functools
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

# the warp-route kernels' instances, by library: the fp32 ones (their
# mangled names hold "<kernel>If"), and every one of the backtraces, whose
# rows are int (named by RW alone)
KERNELS = {"fcc": ("fcc_fwd_warp_kernelIf", "fcc_fwd_log_kernelIf", "fcc_beta_warp_kernelIf",
                   "fcc_beta_log_kernelIf", "fcc_bwd_post_kernelIf", "fcc_bwd_sums_kernelIf"),
           "fac": ("fac_alpha_band_kernelIf", "fac_alpha_warp_kernelIf",
                   "fac_alpha_fill_kernelIf", "fac_beta_warp_kernelIf"),
           "viterbi": ("align_forward_warp_kernelIf", "viterbi_backtrace_warp_kernelI",
                       "align_backtrace_warp_kernelI")}
KINDS = {"fp_arith": r"^(FFMA|FMUL|FADD|DFMA|DMUL|DADD)", "lds": r"^LDS", "sts": r"^STS",
         "mufu": r"^MUFU", "shfl": r"^SHFL", "redux": r"^REDUX", "warpsync": r"^WARPSYNC",
         "bar": r"^BAR", "ldg": r"^LDG", "stg": r"^STG", "branch": r"^(BRA|BSSY|BSYNC)",
         "local": r"^(LDL|STL)"}


def sass(lib, markers=None):
    """{mangled kernel name: its SASS lines} for the kernels whose mangled
    names hold one of ``markers`` in the library or cubin ``lib`` (every
    kernel for None)."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if markers is None or any(k in m.group(1)
                                                        for k in markers) else None
            if name:
                out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.split("*/", 1)[1].strip().rstrip(";").strip())
    return out


def sass_counts(lines):
    """{"instructions": n, "by_kind": {kind: n}} of a kernel's SASS lines
    (KINDS)."""
    ops = [ln.split()[0] if not ln.startswith("@") else ln.split()[1] for ln in lines if ln]
    counts = collections.Counter()
    for op in ops:
        for kind, pattern in KINDS.items():
            if re.match(pattern, op):
                counts[kind] += 1
    return {"instructions": len(ops), "by_kind": dict(counts)}


def cut_anonymous(name):
    """A mangled name with its anonymous namespace (``<length>_GLOBAL__N_...``,
    whose tag differs from file to file) cut out."""
    m = re.search(r"(\d+)(_GLOBAL__N_)", name)
    if not m:
        return name
    return name[:m.start()] + name[m.start(2) + int(m.group(1)):]


def same_sass(parent_root, out_dir):
    """{source: {"same": n, "differs": [...], "only_here": [...],
    "only_parent": [...]}}, "differs" giving each differing kernel's first
    pair of unequal lines: each ``csrc/*.cu`` of this checkout and of
    ``parent_root`` compiled to a cubin (one nvcc each, all at once) and
    disassembled, kernel by kernel."""
    nvcc = _build.nvcc_path()
    flags = list(_build.NVCC_FLAGS[:4]) + ["-O3"]  # the target, C++17, -O3
    roots = {"here": ROOT, "parent": Path(parent_root).resolve()}
    procs = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for tag, root in roots.items():
            path = root / src.relative_to(ROOT)
            if path.exists():
                cubin = out_dir / f"{src.stem}-{tag}.cubin"
                procs[src.stem, tag] = (cubin, subprocess.Popen(
                    [nvcc, *flags, "-cubin", "-o", str(cubin), str(path)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    listings = {}
    for key, (cubin, proc) in procs.items():
        log, _ = proc.communicate()
        c.check(proc.returncode == 0, f"nvcc -cubin failed for {key}:\n{log}")
        # the listing's column widths follow the file's longest line
        listings[key] = {cut_anonymous(k): [" ".join(line.split()) for line in v]
                         for k, v in sass(cubin).items()}
    report = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        here, parent = (listings.get((src.stem, tag), {}) for tag in roots)
        common = sorted(set(here) & set(parent))
        report[src.stem] = {
            "same": sum(here[k] == parent[k] for k in common),
            "differs": {k: next([a, b] for a, b in zip(here[k] + [""], parent[k] + [""])
                                if a != b)
                        for k in common if here[k] != parent[k]},
            "only_here": sorted(set(here) - set(parent)),
            "only_parent": sorted(set(parent) - set(here)),
        }
    return report


# K6's chain with other fp32 exps and logs: the accurate ones, and the
# intrinsics that guard denormals
CHAIN_EXP = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));\n'
             '  return r;\n')
CHAIN_LOG = ('  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));\n'
             '  return r * 0.6931471805599453f;\n')
# ... and two probes of what paces a block step (their outputs are wrong):
# no refill of the ring of bands, and the last row alone stored
REFILL = ("      // block j + D's bands into the slot just read (past the last block:\n"
          "      // the spare blocks, never consumed)\n#pragma unroll\n"
          "      for (int i = 0; i <= K; ++i) {\n#pragma unroll\n"
          "        for (int r = 0; r < RS; ++r) ring[u][i][r] = wb[i * WS + 32 * r];\n"
          "      }\n")
BLOCK = "constexpr int kAlphaBlock = 4;\n"
K6_VARIANTS = {
    "block_2": [(BLOCK, BLOCK.replace("4", "2"))],
    "block_8": [(BLOCK, BLOCK.replace("4", "8"))],
    "accurate_exp_log": [(CHAIN_EXP, "  return expf(x);\n"),
                         (CHAIN_LOG, "  return logf(x);\n")],
    "intrinsic_exp_log": [(CHAIN_EXP, "  return __expf(x);\n"),
                          (CHAIN_LOG, "  return __logf(x);\n")],
    "probe_no_band_refill": [(REFILL, "")],
    "probe_last_row_only": [("        if (has[r] && j < nblocks) row[32 * r] = a[r];\n",
                             "        if (has[r] && j == nblocks - 1) row[32 * r] = a[r];\n")],
}


def build_variants(source, variants, out_dir):
    """{"baseline": this checkout's library of ``csrc/<source>.cu``, variant:
    the library of a copy patched by that variant's (old, new) pairs}, the
    copies built in ``out_dir`` (one nvcc each, all at once); each copy's
    ``-Xptxas -v`` output is kept beside it as ``<variant>.log``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, pairs in variants.items():
        text = src
        for old, new in pairs:
            c.check(text.count(old) == 1, f"patch does not apply: {old!r}")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {"baseline": _build.load(source)}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        c.check(proc.returncode == 0, f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k6_variants(dev):
    """{variant: {dtype: {"ms": [ms in turns], "max_abs_err": x}}} for K6's
    warp route at chip_smoke.py's training shape (fp64: the block sweep
    alone), each variant's error taken against ``fac_alpha_plain``."""
    from torch_asg_tpu_torch.ops.fac import AlignedLattice, make_aligned
    from torch_asg_tpu_torch.ops.kernels import common as kc
    from torch_asg_tpu_torch.ops.kernels import fac_kernels as ak

    libs = build_variants("fac", K6_VARIANTS, _build.BUILD / "k6_variants")

    rng = np.random.default_rng([c.SEED, 4])
    lat32 = make_aligned(*c.lattice_case(rng, dev, torch.float32, c.B, c.T, c.N, c.S,
                                         (500, 1000), (10, c.S)))
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        lat = AlignedLattice(*(x.to(dtype) for x in lat32[:3]), lat32.targets)
        want = ak.fac_alpha_plain(lat)
        calls = {}
        for name, lib in libs.items():
            block = int(name[6:]) if name.startswith("block_") else ak.FAC_ALPHA_BLOCK
            if tag == "f64" and not (name == "baseline" or name.startswith("block_")):
                continue
            nblocks = -(-(c.T - 1) // block)
            band = torch.empty((nblocks + ak._BAND_SPARE, c.B, block + 1, 64), dtype=dtype,
                               device=dev)
            alpha = torch.empty_like(lat.inputs)
            args = [kc.ptr(x) for x in (lat.inputs, lat.self_trans, lat.next_trans, alpha, band)]
            args += [c.T, c.B, c.S, kc.post_chunk(nblocks, c.B)]
            fn = getattr(lib, f"fac_alpha_warp_{tag}")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            c.check(fn(*args, kc.stream_ptr(dev)) == 0, f"{name} {tag}: launch failed")
            torch.cuda.synchronize()
            out.setdefault(name, {})[tag] = {
                "block": block, "ms": [],
                "max_abs_err": None if name.startswith("probe") else c.max_err(alpha, want)}
            calls[name] = functools.partial(fn, *args, kc.stream_ptr(dev))
        names = list(calls)
        for name in names + names[::-1]:
            out[name][tag]["ms"].append(c.time_ms(calls[name]))
    return out


# K11's and K13's warp route (``backtrace_warp`` in viterbi.cu) patched: the
# step's value held in lane u of a group and stored by one instruction a
# group, in place of lane 0's store a step (``batched_stores``); each of the
# lane's words shuffled and the one wanted selected after the shuffles, in
# place of one shuffle of the word selected before it
# (``shuffle_each_word``); each word's next index and stored value formed
# off the chain from the ring, so that the chain is the select, one shuffle
# and the range's select, with a second shuffle for the stored value
# (``two_shuffles``); and the first design's pieces: the word picked by a
# test of s >> 5 against its index (``eq_select``), the refill loads under
# a condition (``predicated_refill``), an exit inside the unrolled group
# (``exit_in_group``).
BT_STEP = "      const int t = t0 - u;  // reads row t + 1 from slot u\n"
BT_STORE = ("      if (lane == 0 && t >= 0) *dst = x;\n"
            "      dst -= batch;\n")
BT_DST = "  int* dst = out + (size_t)(live - 2) * batch + b;  // frame live - 2\n"
BT_GROUP_END = "      src -= t > kRing ? stride : 0;\n    }\n  }\n}\n"
BT_SELECT = ("      int w = 0;  // the lane's word s >> 5 of the row, 0 past the last\n"
             "#pragma unroll\n"
             "      for (int r = RW - 1; r >= 0; --r) w = s < 32 * (r + 1) ? ring[u][r] : w;\n"
             "      const int v = __shfl_sync(kFull, w, s & 31);\n")
BT_CHAIN = ("      const int s = x > 0 ? x : 0;\n" + BT_SELECT +
            "      x = kAlign ? s - v : v;\n")
BT_REFILL = "      for (int r = 0; r < RW; ++r) ring[u][r] = has[r] ? src[32 * r] : 0;\n"
BT_VARIANTS = {
    "batched_stores": [
        (BT_STORE, "      held = lane == u ? x : held;\n"),
        (BT_DST, "  int held = -1;  // lane u: the value of frame t0 - u\n"),
        (BT_GROUP_END, "      src -= t > kRing ? stride : 0;\n    }\n"
                       "    if (lane < kRing && t0 - lane >= 0)"
                       " out[(size_t)(t0 - lane) * batch + b] = held;\n  }\n}\n")],
    "shuffle_each_word": [
        (BT_SELECT, "      int v = 0;\n#pragma unroll\n"
                    "      for (int r = RW - 1; r >= 0; --r) {\n"
                    "        const int g = __shfl_sync(kFull, ring[u][r], s & 31);\n"
                    "        v = s < 32 * (r + 1) ? g : v;\n      }\n")],
    "two_shuffles": [
        (BT_DST, BT_DST + "  int s = x > 0 ? x : 0;  // the chain: the index frame t reads\n"),
        (BT_CHAIN,
         "      int nx[RW], val[RW];  // off the chain: each word's next index and value\n"
         "#pragma unroll\n"
         "      for (int r = 0; r < RW; ++r) {\n"
         "        val[r] = kAlign ? lane + 32 * r - ring[u][r] : ring[u][r];\n"
         "        nx[r] = val[r] > 0 ? val[r] : 0;\n      }\n"
         "      int wn = 0, wv = 0;\n#pragma unroll\n"
         "      for (int r = RW - 1; r >= 0; --r) {\n"
         "        const bool in = s < 32 * (r + 1);\n"
         "        wn = in ? nx[r] : wn;\n        wv = in ? val[r] : wv;\n      }\n"
         "      const bool inside = s < 32 * RW;\n"
         "      const int sn = __shfl_sync(kFull, wn, s & 31);\n"
         "      x = __shfl_sync(kFull, wv, s & 31);\n"
         "      x = inside ? x : (kAlign ? s : 0);\n"
         "      s = inside ? sn : (kAlign ? s : 0);\n")],
    "eq_select": [
        ("      for (int r = RW - 1; r >= 0; --r) w = s < 32 * (r + 1) ? ring[u][r] : w;\n",
         "      for (int r = 0; r < RW; ++r) w = s >> 5 == r ? ring[u][r] : w;\n")],
    "predicated_refill": [
        (BT_REFILL, "      for (int r = 0; r < RW; ++r)"
                    " ring[u][r] = t >= kRing && has[r] ? src[32 * r] : 0;\n")],
    "exit_in_group": [(BT_STEP, BT_STEP + "      if (t < 0) break;\n")],
}


def bt_variants(dev):
    """{kernel: {variant: {"ms": [ms in turns], "equal": bool}}} for K11's
    and K13's warp routes at chip_smoke.py's serving shape (K11 on K10's
    backpointers, K13 on K12's advance bits; and both at 128 labels or
    slots on random rows, ``K11_w128``, ``K13_w128``), each launched directly from
    this checkout's library and from the patched copies of BT_VARIANTS, and
    checked against its plain version; and {variant: spill bytes of each
    warp instance}."""
    from torch_asg_tpu_torch.ops.fac import make_aligned
    from torch_asg_tpu_torch.ops.kernels import common as kc
    from torch_asg_tpu_torch.ops.kernels import viterbi_kernels as vk

    out_dir = _build.BUILD / "bt_variants"
    libs = build_variants("viterbi", BT_VARIANTS, out_dir)
    markers = ("viterbi_backtrace_warp_kernelI", "align_backtrace_warp_kernelI")
    spills = {name: {k: v for marker in markers
                     for k, v in c.spill_bytes((out_dir / f"{name}.log").read_text(),
                                               marker).items()}
              for name in BT_VARIANTS}
    # each copy's backtrace kernels, disassembled beside it
    for name in BT_VARIANTS:
        for kernel, lines in sass(out_dir / f"{name}.so", markers).items():
            (out_dir / f"{name}-{cut_anonymous(kernel)[:80]}.sass").write_text(
                "\n".join(lines) + "\n")
            spills[name][cut_anonymous(kernel)[:80] + "_sass"] = sass_counts(lines)
    rng = np.random.default_rng([c.SEED, 90])
    trans, inputs, targets, li, lo = c.lattice_case(rng, dev, torch.float32, c.B, c.T, c.N,
                                                    c.S, (500, c.T), (10, c.S))
    d_end, bp = vk.viterbi_forward_pallas(trans, inputs, li)
    final = vk.argmax_first(d_end, dim=1)[1].to(torch.int32)
    adv = vk.align_forward_pallas(make_aligned(trans, inputs, targets, li, lo), li)[1]
    end_s = (lo - 1).to(torch.int32)
    # and at 128 labels or slots (RW = 4), on rows drawn at random
    wide = torch.as_tensor(rng.integers(0, 128, size=(c.T, c.B, 128)), dtype=torch.int32,
                           device=dev)
    bits = torch.as_tensor(rng.integers(0, 2, size=(c.T, c.B, 128)), dtype=torch.int32,
                           device=dev)
    starts = torch.as_tensor(rng.integers(0, 128, size=c.B), dtype=torch.int32, device=dev)
    cases = {"K11": ("viterbi_backtrace_warp", bp, final,
                     vk.viterbi_backtrace_plain(final, bp, li)),
             "K13": ("align_backtrace_warp", adv, end_s,
                     vk.align_backtrace_plain(end_s, adv, li)),
             "K11_w128": ("viterbi_backtrace_warp", wide, starts,
                          vk.viterbi_backtrace_plain(starts, wide, li)),
             "K13_w128": ("align_backtrace_warp", bits, starts,
                          vk.align_backtrace_plain(starts, bits, li))}
    out = {}
    for kernel, (entry, rows, start, want) in cases.items():
        calls = {}
        for name, lib in libs.items():
            got = torch.empty_like(want)
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            args = [kc.ptr(x) for x in (rows, start, li, got)] + [c.T, c.B, rows.shape[2],
                                                                   kc.stream_ptr(dev)]
            c.check(fn(*args) == 0, f"{kernel} {name}: launch failed")
            torch.cuda.synchronize()
            out.setdefault(kernel, {})[name] = {"ms": [], "equal": torch.equal(got, want)}
            calls[name] = functools.partial(fn, *args)
        names = list(calls)
        for name in names + names[::-1]:
            out[kernel][name]["ms"].append(c.time_ms(calls[name]))
    return out, spills


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
        for lib, markers in KERNELS.items():
            log = libs[lib].with_suffix(".log").read_text()
            for marker in markers:
                usage.update(c.spill_bytes(log, marker))
            listings.update(sass(libs[lib], markers))
        for name, lines in listings.items():
            (out_dir / f"{name[:120]}.sass").write_text("\n".join(lines) + "\n")
            c.emit({"kernel": name, **sass_counts(lines), "spill_bytes": usage.get(name)})
    if "--same-sass" in argv:
        out_dir = _build.BUILD / "sass"
        out_dir.mkdir(parents=True, exist_ok=True)
        report = same_sass(argv[argv.index("--same-sass") + 1], out_dir)
        for src, r in report.items():
            c.emit({"source": src, "same": r["same"], "differs": r["differs"],
                    "only_here": len(r["only_here"]), "only_parent": len(r["only_parent"])})
    if "--k6-variants" in argv:
        c.emit({"k6_variants": k6_variants(torch.device("cuda", 0))})
    if "--bt-variants" in argv:
        times, spills = bt_variants(torch.device("cuda", 0))
        c.emit({"bt_variants": times, "bt_variant_spill_bytes": spills})
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

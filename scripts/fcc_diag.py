#!/usr/bin/env python3
"""The warp routes of the per-lattice tier (K3-K7), of the alignment
forward (K12) and of the two backtraces (K11, K13) on one CUDA card: what
the compiler made of them, whether a change left every kernel's machine
code as it was, and their checks alone.

    python3 scripts/fcc_diag.py [--sass] [--same-sass PARENT_ROOT] [--check K3,K5]

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
  --check: ``chip_smoke.check_lattice_kernels`` restricted to the named
           kernels (each on both routes in every case, against its plain
           version), printing the kernels' lines.
Run from the repository root on a machine with the CUDA toolkit.
"""

import collections
import re
import subprocess
import sys
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
    if "--check" in argv:
        only = tuple(argv[argv.index("--check") + 1].split(","))
        out = c.check_lattice_kernels(np.random.default_rng([c.SEED, 4]),
                                      torch.device("cuda", 0), only=only)
        for k in out:
            c.emit({"phase": "kernel", **k})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

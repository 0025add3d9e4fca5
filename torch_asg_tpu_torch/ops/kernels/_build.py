"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into ``build/``
beside this file.  The library's file name carries a hash of its source,
the headers beside it and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.
``build_all`` starts one nvcc per source at once and waits for all of them;
the compiler's output (register and shared-memory use, from
``-Xptxas -v``) is kept beside each library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "build"
SOURCES = ("asg_fwd", "asg_bwd", "bigvocab", "viterbi", "fcc", "fac", "conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every header under
    ``csrc/`` (a source may include any of them) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc process per source, all
    started together.  Returns {name: path}; raises with the compiler's
    output if any build fails."""
    with _LOCK:
        BUILD.mkdir(parents=True, exist_ok=True)
        paths = {n: library_path(n) for n in names}
        todo = {n: p for n, p in paths.items() if not p.exists()}
        if not todo:
            return paths
        nvcc = nvcc_path()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            todo[n].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build_all((name,))[name]))

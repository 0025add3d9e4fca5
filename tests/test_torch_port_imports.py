"""The port stands alone: importing it (every module, and the three
``examples/*_torch.py``) loads no JAX, no Flax and nothing of the JAX
package, and builds nothing; and ``chip_smoke.py`` refuses to run without
a card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import torch_asg_tpu_torch
import torch_asg_tpu_torch.asg, torch_asg_tpu_torch.convert
import torch_asg_tpu_torch.models, torch_asg_tpu_torch.runtime
import torch_asg_tpu_torch.ops.viterbi, torch_asg_tpu_torch.ops.kernels._build
import torch_asg_tpu_torch.models.train, torch_asg_tpu_torch.ops.kernels.asg_kernels
import torch_asg_tpu_torch.ops.fcc, torch_asg_tpu_torch.ops.fac, torch_asg_tpu_torch.ops.semiring
import torch_asg_tpu_torch.ops.kernels.bigvocab_kernels
import torch_asg_tpu_torch.ops.kernels.viterbi_kernels, torch_asg_tpu_torch.ops.kernels.common
import torch_asg_tpu_torch.ops.kernels.fcc_kernels, torch_asg_tpu_torch.ops.kernels.fac_kernels
import torch_asg_tpu_torch.ops.posteriors
import torch_asg_tpu_torch.runtime.bucketing, torch_asg_tpu_torch.runtime.prefetch
import torch_asg_tpu_torch.ops.streaming, torch_asg_tpu_torch.ops.wfsa
import torch_asg_tpu_torch.compat, torch_asg_tpu_torch.torch_compat
import torch_asg_tpu_torch.parallel, torch_asg_tpu_torch.parallel.launch
import torch_asg_tpu_torch.parallel.collectives, torch_asg_tpu_torch.parallel.mesh
import torch_asg_tpu_torch.parallel.distributed, torch_asg_tpu_torch.parallel.data_parallel
import torch_asg_tpu_torch.parallel.vocab_parallel
import torch_asg_tpu_torch.parallel.sequence_parallel
import torch_asg_tpu_torch.utils.profiling
sys.path.insert(0, "examples")
import train_asg_torch, stream_decode_torch, nbest_rescore_torch
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'torch_asg_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_exports_every_name_of_the_jax_package():
    """Each name of the JAX package's ``__all__`` is in the port's, and
    resolves."""
    import torch_asg_tpu
    import torch_asg_tpu_torch

    missing = sorted(set(torch_asg_tpu.__all__) - set(torch_asg_tpu_torch.__all__))
    assert not missing, missing
    for name in torch_asg_tpu_torch.__all__:
        assert getattr(torch_asg_tpu_torch, name) is not None


@pytest.mark.parametrize("package", ["parallel", "models"])
def test_port_subpackages_export_every_name_of_the_jax_package(package):
    """The same for the ``parallel`` and ``models`` packages."""
    import importlib

    jax_mod = importlib.import_module(f"torch_asg_tpu.{package}")
    port_mod = importlib.import_module(f"torch_asg_tpu_torch.{package}")
    missing = sorted(set(jax_mod.__all__) - set(port_mod.__all__))
    assert not missing, missing
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None


def test_runtime_import_builds_nothing(tmp_path):
    """Importing the runtime (a copy of the package, so no other test's build
    is seen) leaves no file under ``runtime/build/``."""
    shutil.copytree(REPO / "torch_asg_tpu_torch", tmp_path / "torch_asg_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path)
    code = ("import torch_asg_tpu_torch.runtime as rt; "
            "assert rt.host.BUILD.parent.parent.parent == __import__('pathlib').Path("
            f"{str(tmp_path)!r}).resolve()")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    build = tmp_path / "torch_asg_tpu_torch" / "runtime" / "build"
    assert not build.exists() or not any(build.iterdir())


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a CUDA device, or alone without the package, the script
    exits nonzero and prints no result."""
    import torch

    if not alone and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    env = _env()
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

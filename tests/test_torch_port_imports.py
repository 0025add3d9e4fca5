"""The port stands alone: importing it loads no JAX, no Flax and nothing of
the JAX package; and ``chip_smoke.py`` refuses to run without a card."""

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

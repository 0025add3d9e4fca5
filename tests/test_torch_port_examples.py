"""Smoke tests of the PyTorch port's examples (tiny shapes, ``--device
cpu``), the twins of ``tests/test_examples.py``: each must run end to end
and pass its own internal assertions (``stream_decode_torch`` pins
streaming == one-shot; ``train_asg_torch`` trains, checkpoints, resumes and
decodes)."""

import os
import sys

import pytest

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "examples")
sys.path.insert(0, _EX)


def test_stream_decode_example():
    import stream_decode_torch

    assert stream_decode_torch.main(
        ["--frames", "18", "--chunk", "6", "--beam", "2", "--device", "cpu"]) == 0


def test_nbest_rescore_example():
    import nbest_rescore_torch

    assert nbest_rescore_torch.main(["--k", "4", "--device", "cpu"]) == 0


def test_train_asg_example(tmp_path):
    import train_asg_torch

    assert train_asg_torch.main([
        "--steps", "2", "--batch-size", "2", "--impl", "scan",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu",
    ]) == 0


def test_train_asg_example_resumes_from_its_checkpoint(tmp_path, capsys):
    """Ten steps write a checkpoint at step 10; a second run restores it and
    goes on from step 10."""
    import train_asg_torch

    args = ["--batch-size", "2", "--impl", "scan", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert train_asg_torch.main(["--steps", "10", *args]) == 0
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["step_00000010.pt"]
    capsys.readouterr()
    assert train_asg_torch.main(["--steps", "1", *args]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 10" in out and "step   10  loss" in out

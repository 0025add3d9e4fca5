"""Pools and requests come from the seed alone: the same seed gives the
same inputs, another seed other inputs over the same lengths."""

import numpy as np
import pytest

from bench_h100 import data, harness, seeds, weights

CELLS = ["letters-train", "letters-serve"]


def batch(name, seed, index=0):
    cell = harness.load_cell(name, seed, 1, False)
    return data.raw_batch(cell.traffic, cell.config, seed, index)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    big = 2 ** 31 + 12345
    (u1, l1), (u2, l2) = batch(name, big), batch(name, big)
    assert all(np.array_equal(a, b) for a, b in zip(u1, u2))
    assert l1 is None or all(np.array_equal(a, b) for a, b in zip(l1, l2))


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_other_inputs_same_lengths(name):
    (u1, l1), (u2, l2) = batch(name, 5), batch(name, 6)
    assert sorted(map(len, u1)) == sorted(map(len, u2))
    assert not all(np.array_equal(a, b) for a, b in zip(u1, u2) if len(a) == len(b))
    other = batch(name, 5, index=1)[0]
    assert not np.array_equal(np.concatenate(u1), np.concatenate(other))


@pytest.mark.parametrize("name", ["letters-train"])
def test_transcripts_fit_and_run_at_the_stated_rate(name):
    cell = harness.load_cell(name, 9, 1, False)
    utts, labels = batch(name, 9)
    host = data.host_prep(utts, labels, cell.config, cell.traffic)
    assert host["targets"].shape[1] == cell.traffic["pad_targets"]
    assert host["features"].shape[1] == cell.traffic["pad_frames"]
    secs = np.array([len(u) for u in utts]) / cell.config["feature_rate_hz"]
    rate = np.array([len(l) for l in labels]) / secs
    want = cell.traffic["units_per_second"]
    assert abs(rate.mean() / want - 1) < 0.05
    stride = cell.config["model"]["frontend_stride"]
    frames = -(-host["feature_lengths"] // stride)
    assert (host["target_lengths"] <= frames).all()


def test_weights_from_the_seed():
    import torch

    cell = harness.load_cell("letters-train", 3, 1, False)
    a = weights.make(cell.config, 2 ** 33 + 1, "cpu")
    b = weights.make(cell.config, 2 ** 33 + 1, "cpu")
    c = weights.make(cell.config, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.weight"], c["proj.weight"])
    assert float(a["transition"].abs().max()) == 0.0
    assert seeds.torch_seed(2 ** 40, 1) != seeds.torch_seed(2 ** 40 + 1, 1)

"""work.py's counts against values counted by hand on two small shapes."""

import pytest

from bench_h100 import work


def test_criterion_work_by_hand():
    # two utterances, N=3: lengths 4 and 2 frames (3 and 1 transitions),
    # targets 2 and 1 labels; padded T'=4, S=2
    ops, nbytes = work.criterion_work(3, [4, 2], [2, 1], t_pad=4, s_pad=2)
    per_n = 6 * 9 + 2 * 3  # 60 a transition
    assert ops == 3 * (per_n + 12 * 2) + 1 * (per_n + 12 * 1)  # 252 + 72
    assert nbytes == 4 * (2 * 4 * 2 * 3 + 2 * 2 + 2 * 2 + 2 * 9)


def test_encoder_flops_by_hand():
    model = {"in_features": 2, "channels": 4, "depth": 1, "head_channels": 6,
             "frontend_kernel": 3, "frontend_stride": 2, "kernel": 5, "num_labels": 7}
    # B=1, T=10 -> 5 frames after the stride-2 frontend
    front = 2 * 5 * 4 * 2 * 3
    mid = 2 * 5 * 4 * 4 * 5
    head_conv = 2 * 5 * 6 * 4 * 5
    proj = 2 * 5 * 6 * 7
    assert work.encoder_flops(model, 1, 10, train=False) == front + mid + head_conv + proj
    assert work.encoder_flops(model, 1, 10) == 2 * front + 3 * (mid + head_conv + proj)


def test_bound_takes_the_larger_side():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 6.7e12) == pytest.approx(2.0)

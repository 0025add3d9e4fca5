"""Cells of BENCHMARK.json cut to a size a CPU test can run: the same
loops, checks and readers, with the widths, batches and lengths made
small and the program on its CPU path."""

from __future__ import annotations

import copy

import torch

from bench_h100 import harness

MODEL = {"channels": 16, "depth": 1, "head_channels": 24, "frontend_kernel": 5, "kernel": 3,
         "in_features": 8}
TRAFFIC = {"pool": 4, "batch": 4, "feature_frames": [40, 80], "pad_frames": 80}


def cell(name: str, seed: int = 7, seconds: float = 0.2, trace: bool = False) -> harness.Cell:
    c = harness.load_cell(name, seed, seconds, trace)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(MODEL)
    c.traffic = {**c.traffic, **TRAFFIC}
    if "pad_targets" in c.traffic:
        stride = c.config["model"]["frontend_stride"]
        c.traffic["units_per_second"] = min(c.traffic["units_per_second"],
                                           0.3 * c.config["feature_rate_hz"] / stride)
        c.traffic["pad_targets"] = 40
    if "sample_requests" in c.traffic:
        c.traffic["sample_requests"] = 3
    c.device = torch.device("cpu")
    return c

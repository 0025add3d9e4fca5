"""The gated ConvNet's weights (``configs/conv-glu-librispeech.json``), made
on the device from the seed, under ``GatedConvNet.state_dict()``'s names.

One ``torch.Generator`` on the device draws every ``v`` in one call, in
float32 as the configuration states, split into the leaves and scaled to
variance ``weight_scale`` / fan-in (fan-in C_in K for a convolution, the
input width for a linear layer); each ``g`` is ``||v||`` a row, so every
weight starts equal to its ``v``, as wav2letter initialises weight
normalisation; biases are zero and the transition starts at zero as
``create_train_state`` makes it.  The scale (the configuration's
``weight_scale``, with the readings that chose it) keeps the emissions'
standard deviation with dropout on, as the cell trains, near 1: a GLU layer
passes about 0.29 of its input's variance at unit gain, and each inverted
dropout multiplies it by 1 / (1 - p), so the 18 of them hold the stack's
scale near a gain of 2.1, and past it the stack turns chaotic (float32 then
strays from float64 by whole percents).
"""

from __future__ import annotations

import math

import torch

from . import seeds


def shapes(model: dict) -> dict:
    """{name: shape} of every ``weight_v`` (convolutions (C_out, C_in, K),
    linear layers (out, in))."""
    widths = [model["in_features"]] + [c // 2 for c in model["channels"]]
    out = {f"convs.{i}.weight_v": (cout, cin, k)
           for i, (cin, cout, k) in enumerate(zip(widths, model["channels"], model["kernels"]))}
    out["hidden.weight_v"] = (model["hidden"], widths[-1])
    out["out.weight_v"] = (model["num_labels"], model["hidden"] // 2)
    return out


def make(config: dict, seed: int, device) -> dict:
    """{name: tensor} of every leaf (``weight_v``, ``weight_g``, ``bias``),
    plus a zero ``transition``."""
    model = config["model"]
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, seeds.WEIGHTS))
    sizes = shapes(model)
    draw = torch.randn(sum(math.prod(s) for s in sizes.values()), generator=gen, device=device,
                       dtype=dtype)
    out, at = {}, 0
    for name, shape in sizes.items():
        size = math.prod(shape)
        v = draw[at:at + size].view(shape).mul_(math.sqrt(config["weight_scale"]
                                                          / math.prod(shape[1:])))
        stem = name[:-len(".weight_v")]
        out[name] = v
        out[f"{stem}.weight_g"] = torch.linalg.vector_norm(v, dim=tuple(range(1, len(shape))))
        out[f"{stem}.bias"] = torch.zeros(shape[0], device=device, dtype=dtype)
        at += size
    n = model["num_labels"]
    out["transition"] = torch.zeros((n, n), device=device, dtype=dtype)
    return out


def encoder_state(w: dict) -> dict:
    """The encoder's leaves of ``w``, as ``GatedConvNet.load_state_dict`` takes them."""
    return {k: v for k, v in w.items() if k != "transition"}

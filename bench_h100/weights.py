"""The benchmark's weights, made on the device from the seed.

One ``torch.Generator`` on the device draws every matrix in one call, in
float32 as the configurations state; the draw is split into the leaves and
scaled.  Convolution and head weights are He-normal (variance 2 / fan-in),
so activations keep their scale through the ReLU stack and decoded paths
change label as trained ones do; biases are zero.  The names are the
port's ``Wav2Letter.state_dict()`` keys; the reference takes the same dict.
"""

from __future__ import annotations

import math

import torch

from . import seeds


def shapes(model: dict) -> dict:
    """{leaf name: shape} of the encoder's weights (not the biases)."""
    widths = [(model["in_features"], model["channels"], model["frontend_kernel"])]
    widths += [(model["channels"], model["channels"], model["kernel"])] * model["depth"]
    widths += [(model["channels"], model["head_channels"], model["kernel"])]
    out = {f"blocks.{i}.conv.weight": (cout, cin, k) for i, (cin, cout, k) in enumerate(widths)}
    out["proj.weight"] = (model["num_labels"], model["head_channels"])
    return out


def make(config: dict, seed: int, device, transition_scale: float = 0.0) -> dict:
    """{name: tensor} of every encoder leaf, plus ``transition``: zeros
    when ``transition_scale`` is 0 (a train state's start), else normal
    with that scale (a trained model's, for serving)."""
    model = config["model"]
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, seeds.WEIGHTS))
    sizes = shapes(model)
    n = model["num_labels"]
    total = sum(math.prod(s) for s in sizes.values()) + n * n
    draw = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in sizes.items():
        size = math.prod(shape)
        fan_in = math.prod(shape[1:])
        out[name] = draw[at:at + size].view(shape).mul_(math.sqrt(2.0 / fan_in))
        out[name.replace("weight", "bias")] = torch.zeros(shape[0], device=device, dtype=dtype)
        at += size
    out["transition"] = draw[at:at + n * n].view(n, n).mul_(transition_scale)
    return out


def encoder_state(w: dict) -> dict:
    """The encoder's leaves of ``w``, as ``Wav2Letter.load_state_dict`` takes them."""
    return {k: v for k, v in w.items() if k != "transition"}

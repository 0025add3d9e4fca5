"""Carry weights between the JAX package and this one.

``wav2letter_from_flax`` maps the parameter tree of the JAX package's Flax
``Wav2Letter`` (as NumPy arrays) onto this package's ``Wav2Letter``:
Flax ``Conv`` kernels are (K, Cin, Cout) and become ``Conv1d.weight``
(Cout, Cin, K); the ``Dense`` kernel (C, N) becomes ``Linear.weight`` (N, C);
biases copy.  Flax names the blocks ``ConvBlock_0 .. ConvBlock_{depth+1}``
in order, which are ``blocks.0 ..`` here, and the projection ``Dense_0``,
which is ``proj`` here.

A JAX ``models.train.TrainState`` carries over the same way: its
``params['encoder']`` is the Flax parameter tree above, for
``model.load_state_dict(wav2letter_from_flax(...))``, and its
``params['transition']`` becomes the port's ``TrainState.transition``
through ``state.transition.data.copy_(transition_from_numpy(...))``.  The
optax moments and the step count are not carried: a port ``TrainState``
starts its AdamW state afresh.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.kernels.common import DEFAULT_DEVICE


def wav2letter_from_flax(params) -> dict:
    """state_dict for ``models.Wav2Letter`` from Flax params (NumPy arrays).

    Takes the ``params`` collection itself or a dict holding it under
    ``'params'``."""
    params = params.get("params", params)

    def arr(x):
        return torch.from_numpy(np.array(x))

    state = {}
    blocks = sorted((k for k in params if k.startswith("ConvBlock_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(blocks):
        conv = params[name]["Conv_0"]
        state[f"blocks.{i}.conv.weight"] = arr(conv["kernel"]).permute(2, 1, 0).contiguous()
        state[f"blocks.{i}.conv.bias"] = arr(conv["bias"])
    dense = params["Dense_0"]
    state["proj.weight"] = arr(dense["kernel"]).T.contiguous()
    state["proj.bias"] = arr(dense["bias"])
    return state


def transition_from_numpy(t, device=DEFAULT_DEVICE, dtype=None) -> torch.Tensor:
    """(N, N) transition matrix as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(t), dtype=dtype, device=device)

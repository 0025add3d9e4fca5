"""End-to-end ASG training step: Wav2Letter encoder + ASG criterion.

The train state holds the encoder, the criterion's learned transition matrix
(an ``nn.Parameter`` initialised to zeros) and one optimizer over both.  The
default optimizer is the JAX package's ``optax.adamw(3e-4)``: AdamW with
betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4, applied to every
parameter (torch's own default decay, 1e-2, is not it).  A step updates the
state in place and returns it with the step's loss.

When the model uses dropout, a step draws its masks from one
``torch.Generator`` that advances with every mask drawn, so masks differ
from step to step (the JAX package folds the step count into its key
instead; the two give different bits).

``shard_train_state`` places the state on a ``DeviceMesh`` as DTensors,
after the Flax model's partitioning metadata: convolutions split their
output channels over the 'model' axis, the rest replicates.  A checkpoint
is the ``state_dict`` of the model, the transition and the optimizer, with
the step, through ``torch.save`` and ``torch.load``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..asg import asg_loss
from .wav2letter import Wav2Letter


@dataclass
class TrainState:
    model: Wav2Letter
    transition: nn.Parameter  # (N, N)
    optimizer: torch.optim.Optimizer
    step: int = 0


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4)``'s settings in torch."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def create_train_state(
    model: Wav2Letter,
    optimizer: Optional[Callable] = None,
) -> TrainState:
    """A zero transition on the model's device and in its dtype, and
    ``optimizer(params)`` (default: ``default_optimizer``) over the model's
    parameters followed by the transition."""
    ref = next(model.parameters())
    transition = nn.Parameter(torch.zeros((model.num_labels, model.num_labels),
                                          device=ref.device, dtype=ref.dtype))
    make = default_optimizer if optimizer is None else optimizer
    return TrainState(model, transition, make([*model.parameters(), transition]))


def loss_fn(model: Wav2Letter, state: TrainState, batch, impl: str = "auto",
            train: bool = False, generator: Optional[torch.Generator] = None):
    """Mean ASG loss of a batch: ``features`` (B, T, F), ``feature_lengths``
    (B,), ``targets`` (B, S), ``target_lengths`` (B,)."""
    emissions = model(batch["features"], train=train, generator=generator)
    input_lengths = model.output_length(batch["feature_lengths"]).to(torch.int32)
    return asg_loss(state.transition, emissions, batch["targets"], input_lengths,
                    batch["target_lengths"], reduction="mean", impl=impl)


def make_train_step(model: Wav2Letter, optimizer: torch.optim.Optimizer,
                    impl: str = "auto",
                    generator: Optional[torch.Generator] = None):
    """(state, batch) -> (state, loss): one forward, ``backward()`` and
    ``optimizer.step()``.  With ``model.dropout > 0`` dropout is on, drawing
    from ``generator`` (default: one on the model's device seeded with 0)."""
    use_dropout = model.dropout > 0.0
    if use_dropout and generator is None:
        generator = torch.Generator(device=next(model.parameters()).device)
        generator.manual_seed(0)

    def train_step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, state, batch, impl, train=use_dropout,
                       generator=generator if use_dropout else None)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


# --- sharding over a DeviceMesh ---------------------------------------------


# The mesh axis the convolutions' output channels split over (the Flax
# model's ``tp_axis``).
TP_AXIS = "model"


def encoder_partition_specs(model: Wav2Letter) -> dict:
    """{parameter name: {mesh axis: placement}} for the encoder.

    As the Flax model's partitioning metadata says: every convolution's
    output channels split over ``TP_AXIS`` (its weight (Cout, Cin, K) and its
    bias along dim 0); the head projection replicates ({})."""
    specs = {}
    for name, module in model.named_modules():
        for pname, _ in module.named_parameters(prefix=name, recurse=False):
            specs[pname] = {TP_AXIS: Shard(0)} if isinstance(module, nn.Conv1d) else {}
    return specs


def _placements(mesh: DeviceMesh, spec: dict) -> tuple:
    names = mesh.mesh_dim_names or ()
    unknown = set(spec) - set(names)
    if unknown:
        raise ValueError(f"mesh has no axis {sorted(unknown)}; its axes are {tuple(names)}")
    return tuple(spec.get(n, Replicate()) for n in names)


def param_shardings(mesh: DeviceMesh, model: Wav2Letter) -> dict:
    """{'encoder': {name: placements}, 'transition': placements}: one
    placement per mesh dimension.  Convolutions split their output channels
    over ``TP_AXIS``; everything else (the transition too) replicates."""
    enc = {n: _placements(mesh, s) for n, s in encoder_partition_specs(model).items()}
    return {"encoder": enc, "transition": _placements(mesh, {})}


def shard_train_state(mesh: DeviceMesh, model: Wav2Letter, state: TrainState) -> TrainState:
    """Place the parameters AND the optimizer state on the mesh as DTensors.

    Each parameter becomes a ``DTensor`` with ``param_shardings``'s
    placements, in the model itself (a module holds its parameters) and in
    the optimizer's groups.  Optimizer state tensors shaped like their
    parameter (AdamW's moments) take its placements, so per-rank optimizer
    memory shrinks with the parameters; the rest replicate: step counters,
    and factored state such as ``torch.optim.Adafactor``'s row and column
    variances, whose reduced shapes a parameter's split would not fit.
    Returns the state with the new transition; call on every rank."""
    shardings = param_shardings(mesh, model)
    rep = shardings["transition"]
    new, placed = {}, {}

    def place(p, placements):
        q = nn.Parameter(distribute_tensor(p.detach(), mesh, placements),
                         requires_grad=p.requires_grad)
        new[p], placed[p] = q, placements
        return q

    for name, module in list(model.named_modules()):
        for pname, p in list(module.named_parameters(recurse=False)):
            full = f"{name}.{pname}" if name else pname
            setattr(module, pname, place(p, shardings["encoder"][full]))
    transition = place(state.transition, rep)
    opt = state.optimizer
    for group in opt.param_groups:
        group["params"] = [new[p] for p in group["params"]]
    moved = {}
    for p, st in opt.state.items():
        moved[new[p]] = {
            k: distribute_tensor(v, mesh, placed[p] if v.shape == p.shape else rep)
            if isinstance(v, torch.Tensor) else v
            for k, v in st.items()}
    opt.state = defaultdict(dict, moved)
    return TrainState(model, transition, opt, state.step)

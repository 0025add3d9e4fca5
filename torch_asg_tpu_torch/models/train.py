"""End-to-end ASG training step: an encoder + the ASG criterion.

The step takes any encoder with ``Wav2Letter``'s interface:
``forward(features, train, generator)`` -> emissions (T', B, N),
``output_length(feature_lengths)``, ``num_labels`` and ``dropout`` (a rate;
above 0 a step turns dropout on).  ``Wav2Letter`` and ``GatedConvNet``
have it; the tensor-parallel step below is ``Wav2Letter``'s alone.

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

``shard_train_state`` places the state on a ('data', 'model')
``DeviceMesh`` as DTensors, after the Flax model's partitioning metadata:
convolutions split their output channels over 'model', the rest
replicates.  ``make_train_step`` on such a state is the tensor-parallel
step, run by every rank of the mesh (one process a rank, as in
``parallel/``), each on its own blocks (``models/wav2letter.py``):

* **Batch.** Each rank passes its block of the global batch along 'data':
  rows [d B/D, (d+1) B/D) for its 'data' coordinate d; every 'model' rank
  of one data group passes the same block (``parallel/``'s per-rank rule
  for a ``P('data', ...)`` batch).
* **Loss.** The step returns the mean over the global batch, the same on
  every rank (``asg_loss_dp``).
* **Parameters.** After the step, ``p.full_tensor()`` of every parameter
  is the single-process step's; each convolution's weight and bias stay
  ``Shard(0)`` over 'model', the head and the transition ``Replicate()``.
  The encoder's gradients are summed over 'data' once after
  ``backward()`` (the span ``asg.grad_allreduce`` under a profiler); the
  transition's is already whole (``asg_loss_dp``).
* **Meshes.** (1, M), (D, 1) and (D, M).  A batch not divisible by D and
  output channels not divisible by M raise "not divisible" errors; a
  DTensor weight on a mesh without 'model' raises.  No weight is gathered
  or replicated for the forward.  ``torch.optim.Adafactor`` is refused
  where 'model' splits a parameter: its step size and update clipping
  take whole-parameter norms through ``.item()``, which reads only this
  rank's block of a split DTensor.

A checkpoint is the ``state_dict`` of the model, the transition and the
optimizer, with the step, through ``torch.save`` and ``torch.load``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..asg import asg_loss
from ..parallel.collectives import mesh_axis
from ..parallel.data_parallel import asg_loss_dp
from ..utils.profiling import span
from .wav2letter import DP_AXIS, TP_AXIS, Wav2Letter


@dataclass
class TrainState:
    model: nn.Module  # Wav2Letter, GatedConvNet: the interface of the module docstring
    transition: nn.Parameter  # (N, N)
    optimizer: torch.optim.Optimizer
    step: int = 0


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4)``'s settings in torch."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def create_train_state(
    model: nn.Module,
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


def state_mesh(state: TrainState) -> Optional[DeviceMesh]:
    """The mesh of a state placed by ``shard_train_state``; None if plain."""
    t = state.transition
    return t.device_mesh if isinstance(t, DTensor) else None


def loss_fn(model: nn.Module, state: TrainState, batch, impl: str = "auto",
            train: bool = False, generator: Optional[torch.Generator] = None):
    """Mean ASG loss of a batch: ``features`` (B, T, F), ``feature_lengths``
    (B,), ``targets`` (B, S), ``target_lengths`` (B,).  On a sharded state,
    the batch is this rank's block and the mean is the global batch's."""
    emissions = model(batch["features"], train=train, generator=generator)
    input_lengths = model.output_length(batch["feature_lengths"]).to(torch.int32)
    mesh = state_mesh(state)
    if mesh is None:
        return asg_loss(state.transition, emissions, batch["targets"], input_lengths,
                        batch["target_lengths"], reduction="mean", impl=impl)
    return asg_loss_dp(mesh, state.transition.to_local(), emissions, batch["targets"],
                       input_lengths, batch["target_lengths"], axis=DP_AXIS,
                       reduction="mean", impl=impl)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    impl: str = "auto",
                    generator: Optional[torch.Generator] = None):
    """(state, batch) -> (state, loss): one forward, ``backward()`` and
    ``optimizer.step()``; tensor-parallel on a state placed by
    ``shard_train_state`` (module docstring).  With ``model.dropout > 0``
    dropout is on, drawing from ``generator`` (default: one on the model's
    device seeded with 0)."""
    use_dropout = model.dropout > 0.0
    if use_dropout and generator is None:
        generator = torch.Generator(device=next(model.parameters()).device)
        generator.manual_seed(0)

    def train_step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, state, batch, impl, train=use_dropout,
                       generator=generator if use_dropout else None)
        loss.backward()
        mesh = state_mesh(state)
        if mesh is not None:
            # each rank's encoder gradient is its batch block's part
            data = mesh_axis(mesh, DP_AXIS)
            with span("asg.grad_allreduce"):
                for p in model.parameters():
                    dist.all_reduce(p.grad.to_local(), group=data.group)
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


# --- sharding over a DeviceMesh ---------------------------------------------


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
    variances.  Raises, before placing anything, when a convolution's
    output channels do not divide over ``TP_AXIS``, and for
    ``torch.optim.Adafactor`` when ``TP_AXIS`` has more than one rank
    (module docstring).  Returns the state with the new transition; call
    on every rank."""
    shardings = param_shardings(mesh, model)
    rep = shardings["transition"]
    ranks = mesh.size(mesh.mesh_dim_names.index(TP_AXIS))
    if ranks > 1 and isinstance(state.optimizer, torch.optim.Adafactor):
        raise ValueError(
            f"torch.optim.Adafactor cannot step a state split over mesh axis "
            f"{TP_AXIS!r} = {ranks}: its step size and update clipping take "
            f"whole-parameter norms through .item(), which reads only this rank's "
            f"block of a split DTensor")
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv1d) and module.out_channels % ranks:
            raise ValueError(f"layer {name}: output channels {module.out_channels} "
                             f"not divisible by mesh axis {TP_AXIS!r} = {ranks}")
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

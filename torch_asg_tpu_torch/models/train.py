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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

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

"""Acoustic models that emit (T, B, N) label scores, their train step, and
the placement of a train state on a DeviceMesh."""

from .train import (TrainState, create_train_state, default_optimizer,
                    encoder_partition_specs, loss_fn, make_train_step, param_shardings,
                    shard_train_state)
from .wav2letter import ConvBlock, Wav2Letter

__all__ = [
    "ConvBlock",
    "Wav2Letter",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "loss_fn",
    "make_train_step",
    "encoder_partition_specs",
    "param_shardings",
    "shard_train_state",
]

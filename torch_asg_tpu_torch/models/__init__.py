"""Acoustic models that emit (T, B, N) label scores, and their train step."""

from .train import (TrainState, create_train_state, default_optimizer, loss_fn,
                    make_train_step)
from .wav2letter import ConvBlock, Wav2Letter

__all__ = [
    "ConvBlock",
    "Wav2Letter",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "loss_fn",
    "make_train_step",
]

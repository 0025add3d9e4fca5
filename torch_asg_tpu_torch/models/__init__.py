"""Acoustic models that emit (T, B, N) label scores."""

from .wav2letter import ConvBlock, Wav2Letter

__all__ = ["ConvBlock", "Wav2Letter"]

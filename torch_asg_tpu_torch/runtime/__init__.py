"""Host-side runtime helpers."""

from .host import collapse_path

__all__ = ["collapse_path"]

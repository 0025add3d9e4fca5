"""Host-side runtime helpers."""

from .host import cmvn, collapse_path, encode_labels_np, encode_targets, pack_frames

__all__ = ["cmvn", "collapse_path", "encode_labels_np", "encode_targets", "pack_frames"]

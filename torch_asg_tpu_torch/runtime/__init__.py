"""Host-side runtime: the native data path, bucketing and prefetching."""

from .host import (
    cmvn,
    collapse_path,
    encode_labels_np,
    encode_targets,
    has_native_runtime,
    pack_frames,
)
from .bucketing import BucketBatcher, bucket_ladder, pick_bucket
from .prefetch import BatchPrefetcher, device_prefetch

__all__ = [
    "BucketBatcher",
    "bucket_ladder",
    "pick_bucket",
    "pack_frames",
    "encode_targets",
    "encode_labels_np",
    "collapse_path",
    "cmvn",
    "has_native_runtime",
    "BatchPrefetcher",
    "device_prefetch",
]

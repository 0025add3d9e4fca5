"""Shared helpers for the hand-written CUDA kernels.

Dispatch rule, used by every kernel wrapper: tensors on a CUDA device launch
the kernel; tensors on the CPU run the kernel's plain PyTorch version, which
repeats the same arithmetic step by step.  Nothing falls back: a CUDA tensor
that the kernel cannot take raises, and no path moves to the CPU when no
card is found.
"""

from __future__ import annotations

import collections
import ctypes

import torch

# Where entry points that create tensors put them unless told otherwise.
DEFAULT_DEVICE = "cuda"

KERNEL_DTYPES = (torch.float32, torch.float64)

# The routes of the kernels that have two (K1-K8, K10-K13): the warp route,
# one warp per chain of an element (lane l holds labels or slots l, l+32,
# ..., at most 4), up to WARP_MAX_WIDTH; the block route, one thread per
# label or slot (K11, K13: a block staging rows for one walking thread), up
# to the kernel's own cap.
ROUTES = ("warp", "block")
WARP_MAX_WIDTH = 128
# K2's, K5's and K8's warp routes run their posterior kernel, and K10's its
# backpointer pass, as one block of four warps per (element, chunk of
# frames), with enough chunks for 16 blocks on each of the H100's 132 SMs:
# the kernel waits on memory latency, so it wants every warp slot filled
# (PERF.md §6).
POST_BLOCKS = 16 * 132

# The launch ledger: each kernel wrapper adds every launch it makes here
# (``count_launch``).  Readers clear it or compare copies.
LAUNCHES: collections.Counter = collections.Counter()


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises on a mix or on another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will ask for a gradient of any of ``tensors``:
    grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` has exactly the dtype, shape and device a kernel
    takes, and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def c_function(lib: str, stem: str, dtype, num_ptrs: int, num_sizes: int):
    """The C entry point ``<stem>_{f32,f64}`` of ``csrc/<lib>.cu``, built at
    first use: ``num_ptrs`` pointer arguments, then ``num_sizes`` int sizes,
    then the stream; it returns the launch's ``cudaError_t``."""
    from ._build import load

    fn = getattr(load(lib), f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")
    fn.argtypes = ([ctypes.c_void_p] * num_ptrs + [ctypes.c_int] * num_sizes
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def raise_on_error(fn_name: str, err: int) -> None:
    """The C entry points return the launch's ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError_t {err}")


def width_route(width: int) -> str:
    """The route ``'auto'`` takes for a kernel with two routes whose widest
    row is ``width`` words (K1 and K2: max(labels, target slots); K3, K4,
    K5, K10 and K11: labels; K6, K7, K8, K12 and K13: target slots):
    ``'warp'`` up to WARP_MAX_WIDTH, else ``'block'``."""
    return "warp" if width <= WARP_MAX_WIDTH else "block"


def check_route(kernel: str, route, width: int) -> str:
    """The route to launch for ``kernel`` (its id, for messages) whose
    widest row is ``width`` words: ``route``, or ``width_route``'s for
    None; raises ValueError on an unknown route or a width the route does
    not take."""
    if route is None:
        return width_route(width)
    if route not in ROUTES:
        raise ValueError(f"unknown {kernel} route {route!r}; expected one of {ROUTES}")
    if route == "warp" and width > WARP_MAX_WIDTH:
        raise ValueError(f"{kernel}'s warp route takes rows of at most {WARP_MAX_WIDTH} "
                         f"labels or slots; got {width}")
    return route


def count_launch(kernel: str, *kinds: str) -> None:
    """Count one launch of ``kernel`` in ``LAUNCHES``: under its id
    (PERF.md's: ``K1`` score-only, ``K1s``, ``K2`` ... ``K13``, and
    ``conv_fwd``, ``conv_dgrad``, ``conv_wgrad``) and under
    ``<id>.<kind>`` for each kind (a route, or a tiling's name)."""
    LAUNCHES[kernel] += 1
    for kind in kinds:
        LAUNCHES[f"{kernel}.{kind}"] += 1


def post_chunk(t_total: int, num_batches: int) -> int:
    """Frames per chunk of the frame-parallel kernels of K2's, K5's, K8's
    and K10's warp routes (blocks of frames per chunk for K6's band and
    fill kernels): ``POST_BLOCKS`` blocks over the batch, each chunk at
    least one frame."""
    chunks = -(-POST_BLOCKS // max(num_batches, 1))
    return max(1, -(-t_total // chunks))


def exp_rows(x: torch.Tensor):
    """(exp(x - rowmax), rowmax) of a 2-D tensor, with all--inf rows
    mapping to (0, 0)."""
    m = torch.amax(x, dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(x - m[:, None]), m


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax with all--inf rows giving zeros, as the kernels take it:
    exp(x - max) times the reciprocal of the row sum."""
    m = torch.amax(x, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(x - m)
    den = torch.sum(ex, dim=-1, keepdim=True)
    return ex * (1.0 / torch.where(den > 0, den, torch.ones_like(den)))

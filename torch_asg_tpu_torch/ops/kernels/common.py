"""Shared helpers for the hand-written CUDA kernels.

Dispatch rule, used by every kernel wrapper: tensors on a CUDA device launch
the kernel; tensors on the CPU run the kernel's plain PyTorch version, which
repeats the same arithmetic step by step.  Nothing falls back: a CUDA tensor
that the kernel cannot take raises, and no path moves to the CPU when no
card is found.
"""

from __future__ import annotations

import ctypes

import torch

# Where entry points that create tensors put them unless told otherwise.
DEFAULT_DEVICE = "cuda"

KERNEL_DTYPES = (torch.float32, torch.float64)


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

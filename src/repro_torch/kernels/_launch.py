"""What the kernels' launch wrappers share: argument checks and one launch
through a source's plain C entry point.

Every check runs before a library is loaded, so a wrong argument raises
the same way on a machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["require", "launch"]


def require(what: str, name: str, t: torch.Tensor, dtype: torch.dtype,
            ndim: int, device=None) -> torch.device:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on a
    CUDA device (``device`` when given).  Returns its device."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{what}: {name} must be a {ndim}-D {dtype} tensor")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what} takes CUDA tensors on one device; {name} "
                         f"lies on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    return t.device


def launch(source: str, entry: str, args: ctypes.Structure,
           device: torch.device, what: str) -> None:
    """Launch ``entry(&args, stream)`` of ``csrc/<source>.cu`` on PyTorch's
    current stream; raise if the launch was refused."""
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(type(args)), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dqf_error_string.argtypes = [ctypes.c_int]
        lib.dqf_error_string.restype = ctypes.c_char_p
    err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.dqf_error_string(err).decode())

"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device`` — what the CUDA entry points take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle, read
    without building a ``torch.cuda.Stream`` object: the handle is all a
    launch needs."""
    idx = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)

"""Explicit device selection for the port's entry points.

Every entry point takes a device name and runs there. ``"cuda"`` is the
default and means the card: asking for it on a machine without one is an
error, never a quiet move to the CPU. Tests and host-only callers pass
``"cpu"``, on which every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``name`` as a :class:`torch.device`; raises when it names a CUDA
    device that this machine does not have."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the host")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(name)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda | cpu)")
    return dev

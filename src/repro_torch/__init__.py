"""PyTorch/CUDA port of the variability-analysis pipeline.

The package mirrors :mod:`repro`'s layout: ``core`` holds the three
phases (shard generation, the fused phase-2 reduction, the IQR fences),
``ingest`` the profiler SQLite frontend, ``models``/``serve`` the
mamba2 and hymba serving stack, ``train``/``data`` their training (with
``telemetry``'s straggler monitor), and ``kernels`` the hand-written CUDA
kernels that carry phase 2, the fences, the SSD scan and attention on
the card, each beside its plain PyTorch version. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

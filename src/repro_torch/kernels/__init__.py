"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<kernel>/ops.py``). Sources live in ``repro_torch/csrc/`` and
are built at first use by :mod:`repro_torch.kernels._build`: importing
this package builds nothing.

  binstats  per-segment count/sum/sumsq/min/max (flat and timestamp forms)
  flashattn online-softmax attention, causal / sliding-window, grouped KV
  histbin   per-segment log2-bucket histogram counts (flat and timestamp)
  iqr       sort + Tukey fences + flags over a per-bin score table
  rolling   trailing-window rolling mean/std of a series
  ssd       mamba2 SSD chunk scan, forward (state carried across chunks)
"""
from .binstats import binstats, binstats_plain
from .flashattn import flash_attention, flash_attention_plain
from .histbin import histbin, histbin_plain
from .iqr import iqr_fences, iqr_fences_plain
from .rolling import rolling_stats, rolling_stats_plain
from .ssd import ssd_fused, ssd_fused_plain

__all__ = ["binstats", "binstats_plain", "flash_attention",
           "flash_attention_plain", "histbin", "histbin_plain", "iqr_fences",
           "iqr_fences_plain", "rolling_stats", "rolling_stats_plain",
           "ssd_fused", "ssd_fused_plain"]

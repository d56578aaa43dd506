"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<kernel>/ops.py``). Sources live in ``repro_torch/csrc/`` and
are built at first use by :mod:`repro_torch.kernels._build`.

  binstats  per-segment count/sum/sumsq/min/max (flat and timestamp forms)
  flashattn online-softmax attention, causal / sliding-window, grouped KV
  histbin   per-segment log2-bucket histogram counts (flat and timestamp)
  iqr       sort + Tukey fences + flags over a per-bin score table
  ssd       mamba2 SSD chunk scan, forward (state carried across chunks)
"""

#!/usr/bin/env python3
"""Where the time of the cluster-sorted ``iqr`` kernel goes, on one NVIDIA
card.

    python3 scripts/iqr_stage_times.py [--calls 200]

Builds ``src/repro_torch/csrc/iqr.cu`` as it is, and copies of it with one
kind of stage taken out (each an exact text edit, checked to apply), with
nvcc into ``build/iqr_stages/``, all compiles started together. Each
library is then timed in a process of its own through its C entry:
``--calls`` calls captured in one CUDA graph, the graph's replay timed by
CUDA events (so the host's launch rate does not set the pace); the
libraries in one order and then in the reverse order, at four tables:
12,000 float64 scores (16,384 keys, a cluster of 8 CTAs: the analysis
path's size), the micro-bench's 4,096 float32 scores (2 CTAs), 2,000
float64 scores (one CTA) and 120,000 float64 scores (the tile-and-merge
path). The copies compute wrong results: they exist to be timed beside
the kernel. One process a library: several of these libraries loaded
into one process crashed on the card with an illegal instruction, which
the kernel alone never showed in 4,000 calls a table size.

Variants:
  kernel             the source as it is
  no_dsmem_push      the cluster stages write their own shared memory
  no_cluster_stages  the strides across CTAs dropped
  no_warp_stages     the strides across warps dropped (transposes and
                     single exchanges)
  no_shfl_stages     the strides across lanes dropped
  no_reg_stages      the strides inside a thread dropped
  no_sort            the whole network dropped (load, count, fences and
                     outputs remain)

The first line printed is the card's name and power limit as nvidia-smi
gives them; then one line per variant and table. Needs one CUDA card and
nvcc; exits non-zero without either.
"""

from __future__ import annotations

import ctypes
import sys

import stage_variants

SOURCE = stage_variants.ROOT / "src" / "repro_torch" / "csrc" / "iqr.cu"
OUT = stage_variants.ROOT / "build" / "iqr_stages"
TABLES = {"f64/12000": (12_000, "float64"), "f32/micro": (4_096, "float32"),
          "f64/2000": (2_000, "float64"), "f64/120000": (120_000, "float64")}
VARIANTS = {
    "kernel": [],
    "no_dsmem_push": [("c.cluster.map_shared_rank(d, c.rank ^ m)", "d")],
    "no_cluster_stages": [("for (; j >= CTA_KEYS; j >>= 1) cluster_stage("
                           "v, c, k, j);",
                           "for (; j >= CTA_KEYS; j >>= 1) {}")],
    "no_warp_stages": [("    warp_stages(v, c, k);\n", ""),
                       ("for (; j >= 32 * KEYS; j >>= 1) smem_stage(v, c, k,"
                        " j);", "for (; j >= 32 * KEYS; j >>= 1) {}")],
    "no_shfl_stages": [("for (; j >= KEYS; j >>= 1) shfl_stage(v, c, k, j);",
                        "for (; j >= KEYS; j >>= 1) {}")],
    "no_reg_stages": [("  if (j >= 4) reg_stage<4>(v, c.g0, k);\n"
                       "  if (j >= 2) reg_stage<2>(v, c.g0, k);\n"
                       "  if (j >= 1) reg_stage<1>(v, c.g0, k);\n", "")],
    "no_sort": [("    for (int k = 2; k <= a.size; k <<= 1) merge(v, c, k, "
                 "k >> 1);\n", "")],
}


def timer(name: str, table: str):
    """A function that calls library ``name`` on ``table`` once."""
    import numpy as np
    import torch

    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    n, dtype = TABLES[table]
    f64 = dtype == "float64"
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.iqr_fences_f64 if f64 else lib.iqr_fences
    fn.argtypes = [p, p, i, i, ctypes.c_double if f64 else ctypes.c_float,
                   p, p, p, p, p]
    fn.restype = i
    lib.iqr_scratch_bytes.restype = ctypes.c_long
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    s = torch.from_numpy(np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6,
                                 1e8)).to(dev, getattr(torch, dtype))
    occ = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    n_p = max(2, 1 << (n - 1).bit_length())
    scratch = torch.empty(max(lib.iqr_scratch_bytes(n_p, s.element_size()),
                              1), dtype=torch.uint8, device=dev)
    srt = torch.empty_like(s)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(8, dtype=s.dtype, device=dev)

    def call():
        code = fn(s.data_ptr(), occ.data_ptr(), n, n_p, 1.5,
                  scratch.data_ptr(), srt.data_ptr(), flags.data_ptr(),
                  stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return call


def graph(call, calls: int):
    """``calls`` calls captured in one CUDA graph (after a warm-up)."""
    import torch
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            call()
    g.replay()
    torch.cuda.synchronize()
    return g


def time_ms(g, calls: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_variant(name: str, calls: int) -> None:
    """Time one library at every table (run in a process of its own)."""
    graphs = {t: graph(timer(name, t), calls) for t in TABLES}
    for table, g in graphs.items():
        print(f"{name} {table} {time_ms(g, calls):.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(stage_variants.main(__file__, __doc__, SOURCE, OUT,
                                 VARIANTS, time_variant, 200))

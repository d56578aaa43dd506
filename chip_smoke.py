#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--ranks 8] [--duration 120]

Phases, each of which raises (and the script exits non-zero) on failure:

1. card    — name and power limit, as nvidia-smi reports them;
2. build   — compile every CUDA source of the port with nvcc, one process
             per source, all started together (each library's seconds are
             printed), beside a second compile of flashattn.cu, ssd.cu,
             binstats.cu, histbin.cu, iqr.cu and rolling.cu with -Xptxas
             -v; print the counts of HGMMA (wgmma) and UTMALDG (TMA load)
             instructions in the flashattn and ssd libraries' SASS
             (cuobjdump -sass) and the registers and spill bytes of each
             tensor-core instantiation (flash_fwd_wgmma, ssd_wgmma) and of
             the other kernels; fail if a count is 0 or a tensor-core
             instantiation spills;
3. kernels — every kernel entry point against its plain PyTorch version
             on the card at edge shapes (ragged N, all rows invalid, n_seg
             not a multiple of 128 with empty segments, M = 1 and 3; ssd
             with S not a multiple of the chunk, G == H and G < H, P/N
             8/16, 64/16 and 64/128,
             chunks 8, 16 and 128, bfloat16 and float32 B/C with float32
             x, and bfloat16 x, B and C, whose chunk-128 shapes must run
             the tensor-core kernel;
             flash_attention with S not a multiple of the tile, causal
             with window 0, windows of 1, 8 and 16 and one above S,
             non-causal, H / Hkv = 1, 5 and 8, hd 8, 32, 64 and 128, and
             S = 37 with window 8, whose padded query rows see no key,
             in bfloat16 and float32; binstats_flat with one segment
             holding every row, with 50,000 mostly empty segments and with
             one segment far longer than a lane group's stride, and
             unordered rows, which must leave a NaN count and raise in
             BinStats.device_reduce; histbin_flat with one segment holding
             every row, 50,000 mostly empty segments, ids below 0 and at
             or above n_seg, no valid row, and unordered rows, which must
             leave NaN counts and raise in QuantileSketch.device_reduce;
             binstats at 1 bin and 12,000 bins
             (1 and 3 metrics); iqr_fences in float32 at n = 1, 1,000,
             4,096, 5,000 with no occupied bin, 12,000, 16,384, 32,768,
             32,769, 40,000 and 100,000, in float64 at n = 1, 2, 3, 4,096,
             12,000, 16,384, 16,385, 40,000 and 120,000 (one cluster
             launch up to 16,384 keys, the tile-and-merge path above),
             tables of ties, negatives and -0.0, all scores equal and no
             occupied bin at 12,000 and 40,000 in both types, and the
             1e8-ns table of tests/test_torch_fences.py, each equal to the
             plain version exactly; rolling_stats at n = 1 with window
             1, window 16 above n = 5, n = 1,000 with window 100, window
             = n = 1,024, a ragged n = 2,049 with window 64, window 1,500
             above the 1,024-output tile at n = 3,000, and window 1 at
             n = 100, on normal and lognormal(10, 1) stall-like values);
4. micro   — the calls of the reference's kernel micro-bench
             (benchmarks/kernels_bench.py), with its seed, through the
             port's entry points: binstats over 65,536 events into 512
             bins, iqr_fences over 4,096 scores, rolling_stats over 32,768
             values with window 64. The counters are zeroed just before
             and read just after; each of the three must launch, and each
             is held against its plain version on those tensors;
5. main    — the paper's pipeline through ``VariabilityPipeline.run`` on a
             Table-1-sized synthetic trace (8 ranks x 105k kernels + 13.4k
             memcpys, 120 s, 10 ms bins x 4 devices, 3 metrics, moments +
             quantile sketch, p99 fences), backend "torch". The launch
             counters are zeroed just before and read just after; the
             run must launch binstats_flat, histbin_flat and iqr_fences,
             recover the injected anomaly windows and agree with the
             exact "serial" backend on the same store. The inputs each
             wrapper received are kept, and every kernel is then held
             against its plain version on exactly those tensors;
6. stall   — rolling_stats with window 1,024 over each source rank's
             memory-stall series of the main phase's trace, in start
             order (8 ranks x 105,000 values): the series a Fig-1a user
             smooths. The counters are zeroed just before and read just
             after (8 launches); each call is held against the plain
             version. The float32 drift of the reference oracle's formula
             (one float32 prefix over the whole series) is printed beside;
7. delta   — a store grown by an append: the delta aggregation on the card
             must equal a cold one bit for bit;
8. diff    — ``VariabilityPipeline.diff`` of the main phase's store (A)
             against store B, the same Table-1 inventory with the kernel
             names respecialized (name variant 1) and the layer_norm family
             (ids 3, 24, 45) slowed 1.5x, built by the port's phase 1; the
             query is k_stall at 10 ms bins, grouped by kernel name (about
             12,000 bins x 64 names a side). The counters are zeroed just
             before the cold torch diff and read just after: binstats_flat
             and histbin_flat launch once a side; both are held against
             their plain versions on side B's inputs. The verdict must be
             regressed with the injected family ranked first, a self-diff
             must pass, and the serial backend's diff (no caches) must give
             the same verdict and ranked groups with scores within RTOL. A
             summary-warm repeat reads no shard and launches nothing; a
             third call loads the persisted report;
9. service — ``VariabilityPipeline.serve`` of store A on the torch
             backend: 16 client threads send 8 distinct queries (each
             twice) at once through ``QueryClient`` — no grouping and each
             group column, moments alone and with the sketch, mean / p95 /
             p99 scores, 10 ms / 100 ms / 1 s bins, one time window. Every
             response must be 200, a tick must fuse two or more requests,
             one answer must be an in-flight or summary hit, the three
             kernels must launch, and each answer must equal a serial
             service's on a copy of the store (counts and fence flags
             exactly, min/max in float32, means within RTOL); tick latency
             percentiles from ``/v1/stats`` and request wall times are
             printed;
10. stream — the Table-1 trace's rank DBs cut at 90 s and their store;
             ``VariabilityPipeline.stream`` tails them (poll 25 ms) while
             the remaining 30 s arrive in three 10 s batches; a
             ``QueryClient.fences`` long poll receives each batch's events
             and the plane is quiesced before the next. The counters are
             zeroed before the first batch and read after the last: the
             three kernels must launch, with no ingest error. The same
             batches are appended to a copy of the DBs and ingested by
             ``run_append`` without the service: the rows ingested must
             equal its rows batch for batch, and the shard files its
             files byte for byte. The fence state (flags, top windows)
             and the fence query's moments and sketch must equal a cold
             torch run over a cache-free copy of the same shards exactly.
             A from-scratch phase 1 of the final DBs is built for the
             record: its joined-row count and the shard files it differs
             in are printed (phase 1 joins no committed kernel with a
             memcpy appended later, ROADMAP Queue 3); event-to-fence
             p50/p99 are printed;
11. serve  — mamba2-370m at full width and depth (48 layers, d_model
             1024, vocab 50280) in bfloat16, random weights drawn on the
             card from --seed, through ``ServeEngine.generate``: 8
             requests of 2048 prompt tokens, 32 new tokens each. The
             counters are zeroed just before and read just after; the
             prefill must launch ssd_fused once per layer, every launch on
             the tensor-core kernel (48 of 48). The kernel is
             held against its plain version on the first layer's own
             inputs, and a prefill and a generation through the plain
             version must give the same last-token logits (within the
             bfloat16 tolerance below) and first tokens. Device kernel
             time by name for one prefill and 8 decode steps is read
             with torch.profiler;
12. serve-hymba — hymba-1.5b at full width and depth (32 hybrid layers,
             3 global and 29 with window 1024, d_model 1600, vocab 32001,
             128 meta tokens) in bfloat16, random weights drawn on the card
             from --seed, through ``ServeEngine.generate``: 8 requests of
             2048 prompt tokens, 32 new tokens each. The prefill must
             launch flash_attention and ssd_fused once per layer, every
             launch of both on its tensor-core kernel (32 of 32 each). The
             kernels are held against their plain versions on the path's
             own first global and first window layer's attention inputs
             and first layer's SSD inputs; a prefill and a generation
             through the plain versions must agree with the kernels' as
             in the serve phase; prefill(N - 1) + one decode step must
             give prefill(N)'s logits at batch 2 with a prompt longer than
             the window (the meta-token and ring bookkeeping). Device
             kernel time by name is read as in the serve phase;
13. times  — each kernel, its plain version and a one-call PyTorch
             yardstick where one exists, at the main path's shapes, beside
             the kernel's bound: a wrapper call by CUDA events, the
             yardstick by CUDA events, then the device time of a call under
             torch.profiler (after a warm-up cycle of 20 calls and a 1 ms
             spin kernel, so every watched call is kept), split into the
             row's own kernels (those of its .cu source, by name) and the
             wrapper's other device work; the
             whole read twice in turn ("ms" is the first event reading);
             binstats' timestamp form and rolling_stats at the micro
             phase's calls, rolling_stats also at one rank's stall series
             (105,000 values, window 1,024), binstats also at the Table-1
             rows, iqr_fences at the main path's float64 call, at the
             same scores in float32, at the micro phase's float32 call and
             at 120,000 seeded float64 scores (80% occupied), each with
             torch.quantile as the yardstick; the profiler's own-kernel
             count must be 1 a call up to 16,384 keys and at most 16 at
             120,000;
14. host trace — time.perf_counter_ns around each step of the
             rolling_stats, binstats, binstats_flat, histbin_flat and
             iqr_fences wrappers (checks, allocations, library lookup,
             stream lookup, binding call and launch, result check) over
             10,000 calls at their path shapes, nothing synchronised
             inside a call; today's steps (the C++ operator), the same C
             entries through lean ctypes steps (not for iqr_fences), and
             the earlier ctypes wrapper's steps replayed, each beside the
             whole wrapper call; then core.anomaly.iqr_detect at the main
             path's call over 2,000 calls, split into host prep, upload,
             kernel call, the two device-to-host reads and host ranking.

Tolerances: counts, min, max, flags and iqr outputs (sorted table,
flags, stats) exact; float32 sums
rtol 1e-5 (atomics and summation order differ), and for the edge cases
whose cells sum tens of thousands of rows (one segment, one long
segment, one bin) each sum within float32's worst-case summation bound
(n_c + 2) * 2^-24 * sum|term| of the float64 sum; histogram totals exact
with at most 0.1% of rows one bucket over (float32 log2 on a bucket edge);
ssd float32 outputs rtol = atol = 1e-4 (the reference's own), bfloat16
outputs one rounding step (rtol 2^-7); flash_attention float32 outputs
rtol = atol = 2e-4 (the reference's own), bfloat16 one rounding step;
serving logits, computed in bfloat16 through 48 (mamba2) or 32 (hymba)
layers, max |kernel - plain| <= 0.5 and mean <= 0.05, and each request's
first token equal unless the plain logits' top-2 gap is below 0.5; the
same logits bound for hymba's decode continuation; rolling_stats, both
columns, rtol 1e-4 and atol 1e-4 * max(1, max|x|) (the reference's
rtol = atol = 1e-4, scaled for stall-magnitude values).

The last two lines of standard output are a JSON ``kernels`` record and
``{"ok": true, "device": {...}}``. Needs one CUDA card and the ``src/``
tree of this repository; exits non-zero without either.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bfloat16 tensor cores, dense
METRICS = ("k_stall", "m_duration", "m_bytes")
RTOL = 1e-5
SSD_TOL = 1e-4
FLASH_TOL = 2e-4
ROLLING_TOL = 1e-4
BF16_RTOL = 2 ** -7
LOGIT_MAX_TOL = 0.5
LOGIT_MEAN_TOL = 0.05
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
HYMBA_PARAMS = 1_590_080_320     # the reference's count (jax.eval_shape)
CONT_BATCH, CONT_PROMPT = 2, 1100    # 128 meta + 1100 > the 1024 window
# b, s, H, P, G, N, chunk
SSD_EDGE_SHAPES = ((2, 37, 4, 8, 2, 16, 8), (1, 64, 2, 16, 1, 32, 16),
                   (2, 16, 8, 8, 8, 8, 16), (1, 300, 32, 64, 1, 128, 128),
                   (1, 256, 4, 64, 1, 16, 128))
# b, s, H, Hkv, hd, causal, window
FLASH_EDGE_SHAPES = ((2, 37, 4, 4, 8, True, 0), (2, 37, 5, 1, 64, True, 8),
                     (1, 300, 10, 2, 64, True, 16),
                     (1, 300, 8, 1, 128, False, 0),
                     (1, 300, 4, 2, 32, True, 500),
                     (1, 130, 4, 4, 16, True, 1),
                     (1, 1100, 5, 5, 64, True, 1024))
# n, window
ROLLING_EDGE_SHAPES = ((1, 1), (5, 16), (1000, 100), (1024, 1024),
                       (2049, 64), (3000, 1500), (100, 1))
MICRO_EVENTS, MICRO_BINS, MICRO_SCORES = 65_536, 512, 4_096
MICRO_SERIES, MICRO_WINDOW = 32_768, 64
STALL_WINDOW = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


# --- comparisons ------------------------------------------------------------

def moments_err(got, want) -> float:
    """Raise unless two (..., 5) moment tables agree (counts/min/max
    exact, sums rtol 1e-5); return the largest absolute difference."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    for ch in (0, 3, 4):
        if not torch.equal(g[..., ch], w[..., ch]):
            raise AssertionError(f"moments channel {ch} differs")
    diff = (g[..., 1:3] - w[..., 1:3]).abs()
    if bool((diff > RTOL * w[..., 1:3].abs() + 1e-30).any()):
        raise AssertionError(f"sums differ beyond rtol {RTOL}: "
                             f"max abs {float(diff.max())}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def summation_err(got, want, idx, vals, valid) -> float:
    """Raise unless two (..., n_cells, 5) moment tables of cells that sum
    thousands of rows agree: counts, min and max exact; each float32 sum
    within the worst-case bound of float32 summation in any order,
    (n_c + 2) * 2^-24 * sum|term| over the cell's n_c rows, of the float64
    sum of the same terms (a relative tolerance between two float32 sums
    in different orders holds for short cells only). Returns the largest
    absolute difference from the plain version."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    n_cells = g.shape[-2]
    g, w = g.reshape(-1, n_cells, 5), w.reshape(-1, n_cells, 5)
    for ch in (0, 3, 4):
        if not torch.equal(g[..., ch], w[..., ch]):
            raise AssertionError(f"moments channel {ch} differs")
    idx = idx.long().clamp(0, n_cells - 1).cpu()
    x = vals.double().cpu().reshape(g.shape[0], -1)
    ok = valid.double().cpu()
    rows = torch.zeros(n_cells, dtype=torch.float64).index_add_(
        0, idx, torch.ones_like(ok))
    for j in range(g.shape[0]):
        for ch, terms in ((1, x[j] * ok), (2, x[j] * x[j] * ok)):
            exact = torch.zeros(n_cells, dtype=torch.float64).index_add_(
                0, idx, terms)
            mass = torch.zeros(n_cells, dtype=torch.float64).index_add_(
                0, idx, terms.abs())
            bound = (rows + 2) * 2.0 ** -24 * mass
            if bool(((g[j, :, ch] - exact).abs() > bound).any()):
                raise AssertionError(f"channel {ch} beyond the float32 "
                                     "summation bound")
    return float((g - w).abs().max())


def hist_err(got, want) -> float:
    """Raise unless two (..., 384) count tables agree (totals exact, at
    most 0.1% of rows moved, each one bucket over)."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.equal(g.sum(-1), w.sum(-1)):
        raise AssertionError("histogram totals differ")
    d = g - w
    moved = float(d.abs().sum()) / 2
    if float(d.cumsum(-1).abs().sum()) != moved:
        raise AssertionError("a row moved more than one bucket")
    if moved > 1e-3 * max(float(w.sum()), 1.0):
        raise AssertionError(f"{moved} rows changed bucket")
    return float(d.abs().max()) if d.numel() else 0.0


def ssd_err(got, want) -> float:
    """Raise unless two (y, state) pairs agree: float32 within rtol =
    atol = 1e-4, a bfloat16 y within one rounding step; return the
    largest absolute difference."""
    import torch
    worst = 0.0
    for name, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"ssd {name}: {g.dtype}{tuple(g.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        rtol = BF16_RTOL if g.dtype == torch.bfloat16 else SSD_TOL
        g, w = g.double().cpu(), w.double().cpu()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd {name}: non-finite values")
        diff = (g - w).abs()
        if bool((diff > SSD_TOL + rtol * w.abs()).any()):
            raise AssertionError(f"ssd {name} differs: max abs "
                                 f"{float(diff.max())}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def flash_err(got, want) -> float:
    """Raise unless two attention outputs agree: float32 within rtol =
    atol = 2e-4, bfloat16 within one rounding step; return the largest
    absolute difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else FLASH_TOL
    g, w = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("flash: non-finite values")
    diff = (g - w).abs()
    if bool((diff > FLASH_TOL + rtol * w.abs()).any()):
        raise AssertionError(f"flash differs: max abs {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def rolling_err(got, want, x) -> float:
    """Raise unless two (N, 2) rolling (mean, std) tables agree within
    rtol 1e-4 and atol 1e-4 * max(1, max|x|); return the largest absolute
    difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"rolling: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("rolling: non-finite values")
    atol = ROLLING_TOL * max(1.0, float(x.abs().max()))
    diff = (g - w).abs()
    if bool((diff > atol + ROLLING_TOL * w.abs()).any()):
        raise AssertionError(f"rolling differs: max abs {float(diff.max())}"
                             f" (atol {atol})")
    return float(diff.max())


def iqr_err(got, want) -> float:
    import torch
    for key in ("sorted", "flags", "stats"):
        if not torch.equal(got[key].cpu(), want[key].cpu()):
            raise AssertionError(f"iqr {key} differs")
    return 0.0


# --- phases -----------------------------------------------------------------

def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out[0].strip()


# kernels whose registers and spills the build phase prints, by a piece
# of their mangled name: the tensor-core attention and SSD kernels'
# instantiations (a spill there fails the run) and the binstats, histbin,
# iqr, rolling and CUDA-core SSD kernels
PTXAS_SOURCES = ("flashattn", "ssd", "binstats", "histbin", "iqr", "rolling")
TENSOR_CORE = ("flash_fwd_wgmma", "ssd_wgmma")
PTXAS_KERNELS = (("flash_fwd_wgmmaILi16E", "flash_fwd_wgmma<16>"),
                 ("flash_fwd_wgmmaILi32E", "flash_fwd_wgmma<32>"),
                 ("flash_fwd_wgmmaILi64E", "flash_fwd_wgmma<64>"),
                 ("flash_fwd_wgmmaILi128E", "flash_fwd_wgmma<128>"),
                 ("ssd_wgmmaILi16E", "ssd_wgmma<16>"),
                 ("ssd_wgmmaILi32E", "ssd_wgmma<32>"),
                 ("ssd_wgmmaILi64E", "ssd_wgmma<64>"),
                 ("ssd_wgmmaILi128E", "ssd_wgmma<128>"),
                 ("ssd_scan_kernelIfE", "ssd_scan_kernel<float>"),
                 ("ssd_scan_kernelI13__nv_bfloat16E",
                  "ssd_scan_kernel<bf16>"),
                 ("histbin_seg_kernel", "histbin_seg_kernel"),
                 ("binstats_seg_kernel", "binstats_seg_kernel"),
                 ("binstats_ts_cluster_kernel", "binstats_ts_cluster_kernel"),
                 ("iqr_cluster_kernelIfLi0E",
                  "iqr_cluster_kernel<float, single>"),
                 ("iqr_cluster_kernelIdLi0E",
                  "iqr_cluster_kernel<double, single>"),
                 ("iqr_cluster_kernelIdLi1E",
                  "iqr_cluster_kernel<double, tile>"),
                 ("iqr_cluster_kernelIdLi2E",
                  "iqr_cluster_kernel<double, finish>"),
                 ("iqr_merge_kernelIdLi3E", "iqr_merge_kernel<double, 3>"),
                 ("iqr_output_kernelIdE", "iqr_output_kernel<double>"),
                 ("rolling_kernel", "rolling_kernel"))


def _ptxas_report(build):
    """Start a second compile of each of PTXAS_SOURCES with ``-Xptxas -v``
    (beside the build, into a temporary directory); the returned function
    waits for them and returns {kernel: (registers, spill bytes)} for the
    kernels of PTXAS_KERNELS."""
    import re
    out = tempfile.mkdtemp(prefix="ptxas_")
    procs = [subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out, f"{src}.so"), str(build.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES]

    def wait():
        report = {}
        for proc in procs:
            log_text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log_text}")
            name, spill = None, 0
            for line in log_text.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    name = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    for piece, label in PTXAS_KERNELS:
                        if piece in name:
                            report[label] = (int(m.group(1)), spill)
        shutil.rmtree(out, ignore_errors=True)
        return report
    return wait


def _sass_counts(lib_path, build, ops=("HGMMA", "UTMALDG")):
    """How many SASS instructions of each kind the library holds
    (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout.splitlines()
    return {op: sum(op in line for line in sass) for op in ops}


def phase_kernels(dev):
    """Every entry point against its plain version at edge shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd

    rng = np.random.default_rng(1)
    worst = {}

    def rows(n, m, n_seg, invalid=False):
        vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
        vals[:, ::13] = -1.5
        seg = np.sort(rng.integers(0, max(n_seg - 7, 1), n)).astype(np.int32)
        ts = rng.uniform(-1e7, 1.01e9, n).astype(np.float32)
        valid = (np.zeros(n, bool) if invalid else rng.random(n) > 0.1)
        return [torch.from_numpy(x).to(dev) for x in (seg, vals, valid, ts)]

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for n, m, n_seg, invalid in ((1001, 1, 1000, False),
                                 (1001, 3, 1000, True),
                                 (70_001, 3, 4097, False),
                                 (1, 1, 5, False)):
        seg, vals, valid, ts = rows(n, m, n_seg, invalid)
        note("binstats_flat", moments_err(
            bs.binstats_flat(seg, vals, n_seg, valid),
            bs.binstats_flat_plain(seg, vals, n_seg, valid)))
        note("histbin_flat", hist_err(
            hb.histbin_flat(seg, vals, n_seg, valid),
            hb.histbin_flat_plain(seg, vals, n_seg, valid)))
        kw = dict(total_ns=1e9, n_bins=n_seg)
        note("binstats", moments_err(bs.binstats(ts, vals, valid, **kw),
                                     bs.binstats_plain(ts, vals, valid,
                                                       **kw)))
        note("histbin", hist_err(hb.histbin(ts, vals, valid, **kw),
                                 hb.histbin_plain(ts, vals, valid, **kw)))
    # binstats_flat: one segment holding every row, mostly empty segments,
    # one segment far longer than a lane group's stride; the timestamp
    # form at 1 bin and at 12,000 bins (1 and 3 metrics: the cluster
    # kernel, then the three-launch path for a table above 227 KB)
    for n, m, n_seg, long_seg in ((70_001, 2, 1, False),
                                  (1_001, 1, 50_000, False),
                                  (70_001, 3, 64, True)):
        seg, vals, valid, ts = rows(n, m, n_seg)
        if long_seg:
            seg = torch.sort(torch.where(
                (torch.arange(n, device=dev) % 7) > 0,
                torch.full_like(seg, 3), seg)).values
        got = bs.binstats_flat(seg, vals, n_seg, valid)
        want = bs.binstats_flat_plain(seg, vals, n_seg, valid)
        note("binstats_flat", summation_err(got, want, seg, vals, valid)
             if n_seg == 1 or long_seg else moments_err(got, want))
    for n_bins, m in ((1, 1), (12_000, 1), (12_000, 3)):
        seg, vals, valid, ts = rows(65_536, m, n_bins)
        kw = dict(total_ns=1e9, n_bins=n_bins)
        got = bs.binstats(ts, vals, valid, **kw)
        want = bs.binstats_plain(ts, vals, valid, **kw)
        note("binstats", moments_err(got, want) if n_bins > 1 else
             summation_err(got, want, bs._ts_bins(ts, 1e9, n_bins), vals,
                           valid))
    # histbin_flat: one segment holding every row, mostly empty segments,
    # ids below 0 and at or above n_seg (dropped), no valid row
    for n, m, n_seg, lo, hi, invalid in ((70_001, 2, 1, 0, 1, False),
                                         (1_001, 1, 50_000, 0, 50_000,
                                          False),
                                         (9_000, 3, 300, -40, 340, False),
                                         (999, 3, 30, 0, 30, True)):
        seg = torch.from_numpy(np.sort(rng.integers(lo, hi, n))
                               .astype(np.int32)).to(dev)
        _, vals, valid, _ = rows(n, m, n_seg, invalid)
        note("histbin_flat", hist_err(
            hb.histbin_flat(seg, vals, n_seg, valid),
            hb.histbin_flat_plain(seg, vals, n_seg, valid)))
    # unordered rows: NaN counts in the table, and the main path's
    # reducers raise on them
    seg, vals, valid, _ = rows(1001, 3, 1000)
    flipped = seg.flip(0).contiguous()
    if not bs.disordered(bs.binstats_flat(flipped, vals, 1000, valid)
                         .cpu()):
        raise AssertionError("binstats_flat did not flag unordered rows")
    if not hb.disordered(hb.histbin_flat(flipped, vals, 1000, valid)
                         .cpu()):
        raise AssertionError("histbin_flat did not flag unordered rows")
    from repro_torch.core.reducers import BinStats, QuantileSketch
    for reducer in (BinStats, QuantileSketch):
        try:
            reducer.device_reduce(flipped, vals, 1000, dev, valid)
        except ValueError:
            pass
        else:
            raise AssertionError(f"unordered rows did not raise in "
                                 f"{reducer.__name__}.device_reduce")
    # iqr: float32 (the TPU kernel's contract) and float64 (the analysis
    # path's) against their plain versions exactly, one cluster launch up
    # to 16,384 keys and the tile-and-merge path above, at ragged n, no
    # occupied bin, all scores equal, ties, negatives and -0.0
    def iqr_case(s, occ):
        s = torch.from_numpy(s).to(dev)
        occ = torch.from_numpy(occ).to(dev)
        note("iqr_fences", iqr_err(iq.iqr_fences(s, occ),
                                   iq.iqr_fences_plain(s, occ)))
    for n, frac in ((1, 1.0), (1_000, 0.8), (4_096, 0.8), (12_000, 0.7),
                    (5_000, 0.0), (16_384, 0.8), (32_768, 0.8),
                    (32_769, 0.8), (40_000, 0.8), (100_000, 0.6)):
        iqr_case(rng.lognormal(3.0, 0.6, n).astype(np.float32),
                 rng.random(n) < frac)
    for n in (1, 2, 3, 4_096, 12_000, 16_384, 16_385, 40_000, 120_000):
        iqr_case(np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8),
                 rng.random(n) < 0.8)
    for dtype in (np.float32, np.float64):
        for n in (12_000, 40_000):
            ties = (rng.integers(-40, 40, n) / 4).astype(dtype)
            ties[rng.random(n) < 0.05] = -0.0
            iqr_case(ties, rng.random(n) < 0.8)
            iqr_case(np.full(n, 7.5, dtype), rng.random(n) < 0.8)
            iqr_case(ties, np.zeros(n, bool))
    # the 1e8-ns table of tests/test_torch_fences.py
    iqr_case(np.array([1e8, 1e8 + 4, 1e8 + 8, 1e8 + 12, 1e8 + 16, 1e8 + 40]),
             np.ones(6, bool))
    # ssd: float32 x with float32 and bfloat16 B/C (the CUDA-core kernel),
    # and bfloat16 x, B and C (the tensor-core kernel where chunk, P and N
    # allow it: held to the tensor-core count)
    tc_before = sd.ssd_fused.wgmma_launches
    tc_want = 0
    for b, s, H, P, G, N, chunk in SSD_EDGE_SHAPES:
        for x_dtype, bc in ((torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.bfloat16)):
            args = _ssd_inputs(rng, (b, s, H, P, G, N), bc, dev, x_dtype)
            tc_want += (x_dtype == torch.bfloat16 and chunk == 128
                        and P % 16 == 0 and P <= 64 and N % 16 == 0)
            note("ssd_fused", ssd_err(sd.ssd_fused(*args, chunk=chunk),
                                      sd.ssd_fused_plain(*args,
                                                         chunk=chunk)))
    if sd.ssd_fused.wgmma_launches - tc_before != tc_want:
        raise AssertionError(f"{sd.ssd_fused.wgmma_launches - tc_before} "
                             f"tensor-core ssd launches, expected {tc_want}")
    for b, s, H, Hkv, hd, causal, window in FLASH_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd))
                                        .astype(np.float32)).to(dev, dtype)
                       for n in (H, Hkv, Hkv))
            kw = dict(causal=causal, window=window)
            note("flash_attention", flash_err(
                fa.flash_attention(q, k, v, **kw),
                fa.flash_attention_plain(q, k, v, **kw)))
    for n, window in ROLLING_EDGE_SHAPES:
        for x in (rng.normal(0, 1, n), rng.lognormal(10, 1, n)):
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
            note("rolling_stats", rolling_err(
                ro.rolling_stats(x, window=window),
                ro.rolling_stats_plain(x, window=window), x))
    torch.cuda.synchronize()
    return worst


def micro_inputs(dev):
    """The reference micro-bench's inputs (benchmarks/kernels_bench.py),
    with its seed and draws in its order: (ts, vals, valid, scores, occ,
    x) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)
    ts = t(rng.uniform(0, 1e9, MICRO_EVENTS).astype(np.float32))
    vals = t(rng.normal(100, 20, MICRO_EVENTS).astype(np.float32))
    valid = torch.ones(MICRO_EVENTS, dtype=torch.bool, device=dev)
    scores = t(np.abs(rng.normal(10, 4, MICRO_SCORES)).astype(np.float32))
    occ = scores != 0
    x = t(rng.normal(0, 1, MICRO_SERIES).astype(np.float32))
    return ts, vals, valid, scores, occ, x


def iqr_table(dev, n, seed):
    """A float64 per-bin score table of nanosecond sums between 1e6 and
    1e8, 80% of the bins occupied: (scores, occupied) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8)
    occ = rng.random(n) < 0.8
    return torch.from_numpy(s).to(dev), torch.from_numpy(occ).to(dev)


def phase_micro(dev):
    """The reference micro-bench's calls (benchmarks/kernels_bench.py),
    with its seed and draws in its order, through the port's entry points;
    returns (launches, |kernel - plain| by kernel, the calls' tensors)."""
    import torch

    import repro_torch.kernels as K

    ts, vals, valid, scores, occ, x = micro_inputs(dev)
    bs_kw = {"total_ns": 1e9, "n_bins": MICRO_BINS}
    counters = _launch_counters()
    torch.cuda.synchronize()
    _zero(counters)
    moments = K.binstats(ts, vals, valid, **bs_kw)
    fences = K.iqr_fences(scores, occ)
    stats = K.rolling_stats(x, window=MICRO_WINDOW)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"micro: launches {launches}")
    for name in ("binstats", "iqr_fences", "rolling_stats"):
        if launches[name] != 1:
            raise AssertionError(f"the micro-bench call of {name} launched "
                                 f"it {launches[name]} times, expected 1")
    if moments.shape != (MICRO_BINS, 5) or int(moments[:, 0].sum()) != \
            MICRO_EVENTS:
        raise AssertionError("binstats: bad shape or lost events")
    errs = {"binstats": moments_err(moments,
                                    K.binstats_plain(ts, vals, valid,
                                                     **bs_kw)),
            "iqr_fences": iqr_err(fences, K.iqr_fences_plain(scores, occ)),
            "rolling_stats": rolling_err(
                stats, K.rolling_stats_plain(x, window=MICRO_WINDOW), x)}
    log(f"micro: binstats {MICRO_EVENTS} events x {MICRO_BINS} bins, "
        f"iqr_fences {MICRO_SCORES} scores (q1 {float(fences['q1']):.6f}, "
        f"q3 {float(fences['q3']):.6f}, {int(fences['flags'].sum())} "
        f"flags), rolling_stats {MICRO_SERIES} values window "
        f"{MICRO_WINDOW}; largest |kernel - plain| {errs}")
    shapes = {"binstats": ((ts, vals, valid), bs_kw),
              "rolling_stats": (x, MICRO_WINDOW),
              "iqr_fences/micro": ((scores, occ), {})}
    return launches, errs, shapes


def _oracle_f32(x, window):
    """The reference oracle's formula as it computes it: one float32
    prefix over the whole series (only to show its drift)."""
    import torch
    n = x.shape[0]
    zero = x.new_zeros(1)
    cs = torch.cat([zero, torch.cumsum(x, 0)])
    cs2 = torch.cat([zero, torch.cumsum(x * x, 0)])
    i = torch.arange(n, device=x.device)
    lo = (i - window + 1).clamp_min(0)
    n_eff = (i + 1).clamp_max(window).to(torch.float32)
    mean = (cs[i + 1] - cs[lo]) / n_eff
    var = ((cs2[i + 1] - cs2[lo]) / n_eff - mean * mean).clamp_min(0.0)
    return torch.stack([mean, var.sqrt()], dim=1)


def phase_stall(dev, stalls):
    """rolling_stats(window=1024) over each rank's stall series; returns
    (launches, |kernel - plain|, the first rank's call)."""
    import torch

    import repro_torch.kernels as K

    xs = [torch.from_numpy(s).to(dev) for s in stalls]
    counters = _launch_counters()
    torch.cuda.synchronize()
    _zero(counters)
    outs = [K.rolling_stats(x, window=STALL_WINDOW) for x in xs]
    torch.cuda.synchronize()
    launches = counters["rolling_stats"].launches
    if launches != len(xs):
        raise AssertionError(f"{len(xs)} stall series launched rolling_stats"
                             f" {launches} times")
    err, drift = 0.0, [0.0, 0.0]
    for x, out in zip(xs, outs):
        want = K.rolling_stats_plain(x, window=STALL_WINDOW)
        err = max(err, rolling_err(out, want, x))
        d = (_oracle_f32(x, STALL_WINDOW) - want).abs().amax(0) / \
            x.abs().max()
        drift = [max(a, float(b)) for a, b in zip(drift, d)]
    log(f"stall: rolling_stats window {STALL_WINDOW} over {len(xs)} ranks x "
        f"{xs[0].shape[0]} stall values (max {float(max(x.max() for x in xs))}"
        f" ns), {launches} launches; largest |kernel - plain| {err}; the "
        f"oracle's float32 formula drifts by max |dmean| / max|x| "
        f"{drift[0]:.3e}, max |dstd| / max|x| {drift[1]:.3e}")
    return launches, err, (xs[0], STALL_WINDOW)


def _ssd_inputs(rng, shape, bc_dtype, dev, x_dtype=None):
    """Model-layout inputs of ssd_fused: x in ``x_dtype`` (float32 by
    default), dt in [0.01, 0.1]."""
    import torch
    b, s, H, P, G, N = shape

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)
    return (t(rng.normal(size=(b, s, H, P)), x_dtype or torch.float32),
            t(rng.uniform(0.01, 0.1, (b, s, H))), t(rng.uniform(-1, 1, H)),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=H)))


class Capture:
    """Keeps the arguments of the first call each wrapper receives on a
    path (by replacing the module attributes the path looks up), so the
    kernels can afterwards be held against their plain versions — and
    timed — on exactly the path's tensors. ``targets`` lists (module,
    attribute) pairs; a call is kept under the attribute's name, or under
    ``key(name, kwargs)`` when that is given."""

    def __init__(self, targets, key=None):
        self.calls = {}
        self._restore = []
        self._key = key or (lambda name, kwargs: name)
        for mod, name in targets:
            fn = getattr(mod, name)
            self._restore.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            self.calls.setdefault(self._key(name, kwargs), (args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    def close(self):
        for mod, attr, fn in self._restore:
            setattr(mod, attr, fn)


def _cfg(args, backend):
    from repro_torch.core import PipelineConfig
    return PipelineConfig(
        n_ranks=args.ranks, backend=backend, device="cuda", metrics=METRICS,
        group_by="k_device", reducers=("moments", "quantile"),
        anomaly_score="p99", agg_interval_ns=10_000_000)


def _spec(args):
    from repro_torch.core import SyntheticSpec
    return SyntheticSpec(n_ranks=args.ranks, kernels_per_rank=105_000,
                         memcpys_per_rank=13_400,
                         duration_s=float(args.duration), seed=args.seed)


def _launch_counters():
    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd
    return {"binstats_flat": bs.binstats_flat, "binstats": bs.binstats,
            "histbin_flat": hb.histbin_flat, "histbin": hb.histbin,
            "iqr_fences": iq.iqr_fences, "ssd_fused": sd.ssd_fused,
            "flash_attention": fa.flash_attention,
            "rolling_stats": ro.rolling_stats}


def _zero(counters):
    """Set every launch count to 0, the tensor-core counts of
    flash_attention and ssd_fused too."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "wgmma_launches"):
            fn.wgmma_launches = 0


def phase_main(args, work):
    import numpy as np
    import torch

    from repro_torch.core import (VariabilityPipeline, generate_synthetic,
                                  recovered, write_synthetic_dbs)
    from repro_torch.core.aggregation import producer_stats

    ds = generate_synthetic(_spec(args))
    paths = write_synthetic_dbs(ds, os.path.join(work, "dbs"))
    store = os.path.join(work, "store")
    from repro_torch.core import anomaly, distributed
    from repro_torch.kernels.iqr import ops as iq
    counters = _launch_counters()
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat"), (anomaly, "iqr_fences")))
    try:
        _zero(counters)
        t0 = time.perf_counter()
        res = VariabilityPipeline(_cfg(args, "torch")).run(paths, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        cap.close()
    gen = res.generation
    log(f"main: {len(paths)} rank DBs, rows per table {gen.rows_per_table},"
        f" {gen.joined_rows} joined rows, {gen.n_shards} shards; "
        f"phase 1 {gen.seconds:.3f}s, phase 2+3 "
        f"{wall - gen.seconds:.3f}s, total {wall:.3f}s")
    log(f"main: device batch {producer_stats()}")
    log(f"main: launches {launches}; iqr_fences launches through "
        f"torch.ops.{iq._operator()}")
    for name in ("binstats_flat", "histbin_flat", "iqr_fences"):
        if launches[name] < 1:
            raise AssertionError(f"main path never launched {name}")
    frac = recovered(ds.anomaly_windows, res.anomaly_windows,
                     tol_ns=1_000_000_000)
    log(f"main: injected windows recovered {frac * 100:.0f}% "
        f"(top bins {res.anomalies.top_idx.tolist()})")
    if frac < 1.0:
        raise AssertionError("injected anomaly windows not recovered")

    ser = VariabilityPipeline(_cfg(args, "serial")).run(
        paths, os.path.join(work, "store_serial"))
    a, b = res.aggregation.grouped, ser.aggregation.grouped
    occ = b.count > 0
    np.testing.assert_array_equal(a.count, b.count)
    for f in ("min", "max"):
        np.testing.assert_array_equal(
            np.where(occ, getattr(a, f), 0.0),
            np.where(occ, getattr(b, f).astype(np.float32), 0.0))
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                   rtol=RTOL)
    np.testing.assert_array_equal(
        res.aggregation.reduced["quantile"].counts.sum(-1),
        ser.aggregation.reduced["quantile"].counts.sum(-1))
    np.testing.assert_array_equal(res.anomalies.flags, ser.anomalies.flags)
    log(f"main: torch == serial (counts/min/max exact, sums rtol {RTOL}, "
        f"sketch totals exact, {int(res.anomalies.flags.sum())} flags "
        "equal)")
    if not np.isfinite(res.anomalies.scores).all():
        raise AssertionError("non-finite anomaly scores")

    errs = {}
    args_bs, _ = cap.calls["binstats_flat"]
    errs["binstats_flat"] = moments_err(
        counters["binstats_flat"](*args_bs),
        _plain("binstats_flat")(*args_bs))
    args_hb, _ = cap.calls["histbin_flat"]
    errs["histbin_flat"] = hist_err(counters["histbin_flat"](*args_hb),
                                    _plain("histbin_flat")(*args_hb))
    args_iq, kw_iq = cap.calls["iqr_fences"]
    errs["iqr_fences"] = iqr_err(counters["iqr_fences"](*args_iq, **kw_iq),
                                 _plain("iqr_fences")(*args_iq, **kw_iq))
    n_bins = int(res.aggregation.plan.n_shards)
    ts_args = _ts_inputs(args_bs, n_bins)
    errs["binstats"] = moments_err(counters["binstats"](*ts_args[0],
                                                        **ts_args[1]),
                                   _plain("binstats")(*ts_args[0],
                                                      **ts_args[1]))
    errs["histbin"] = hist_err(counters["histbin"](*ts_args[0],
                                                   **ts_args[1]),
                               _plain("histbin")(*ts_args[0],
                                                 **ts_args[1]))
    torch.cuda.synchronize()
    shapes = {"binstats_flat": args_bs, "histbin_flat": args_hb,
              "iqr_fences": (args_iq, kw_iq), "ts": ts_args}
    # each source rank's kernel memory-stall durations (float32 ns) in
    # start order, for the stall phase
    stalls = [tr.kernels.memory_stall[np.argsort(tr.kernels.start,
                                                 kind="stable")]
              for tr in ds.traces]
    return launches, errs, shapes, stalls


class _Plain:
    """Within the block the model's SSD scan and attention call the plain
    versions of their kernels (the attributes ``ssm_forward`` and
    ``attn_forward`` look up are replaced)."""

    def __enter__(self):
        from repro_torch.models import attention, ssm
        self._fns = ((ssm, "ssd_fused", ssm.ssd_fused),
                     (attention, "flash_attention",
                      attention.flash_attention))
        for mod, name, _ in self._fns:
            setattr(mod, name, _plain(name))

    def __exit__(self, *exc):
        for mod, name, fn in self._fns:
            setattr(mod, name, fn)


def _flash_key(name, kwargs):
    """Capture key: the first global and the first window layer's
    attention calls are kept apart."""
    if name != "flash_attention":
        return name
    return f"{name}/{'window' if kwargs.get('window') else 'global'}"


def _expected_launches(cfg):
    """One ssd_fused per SSM or hybrid layer and one flash_attention per
    attention or hybrid layer, in one prefill."""
    n = {"ssd_fused": 0, "flash_attention": 0}
    for spec, count in cfg.plan:
        n["ssd_fused"] += count * (spec.kind in ("ssm", "hybrid"))
        n["flash_attention"] += count * (spec.kind in ("attn", "hybrid"))
    return n


def phase_serve(args, dev, arch, tag):
    """``arch`` served at full width and depth through the port's engine;
    returns (launches, |kernel - plain| on the path's tensors by kernel,
    the captured calls)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention, model, ssm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.telemetry import KIND_DECODE, KIND_PREFILL

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    log(f"{tag}: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.meta_tokens} meta tokens, {n_params} "
        f"parameters in {cfg.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    if arch == "hymba-1.5b" and n_params != HYMBA_PARAMS:
        raise AssertionError(f"{n_params} parameters, the reference has "
                             f"{HYMBA_PARAMS}")
    max_len = cfg.meta_tokens + SERVE_PROMPT + SERVE_NEW
    scfg = ServeConfig(max_len=max_len, max_new_tokens=SERVE_NEW,
                       cache_dtype=cfg.dtype)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))
    # warm-up at a short prompt: library handles, the kernels' attributes
    ServeEngine(cfg, params, ServeConfig(max_len=max_len, max_new_tokens=2),
                device=dev).generate({"tokens": prompts[:, :128]})
    engine = ServeEngine(cfg, params, scfg, device=dev)
    counters = _launch_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                  key=_flash_key)
    try:
        _zero(counters)
        tokens = engine.generate({"tokens": prompts})
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        wgmma = counters["flash_attention"].wgmma_launches
        ssd_tc = counters["ssd_fused"].wgmma_launches
    finally:
        cap.close()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = engine.telemetry.steps
    pre_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
              if e.kind == KIND_PREFILL]
    dec_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
              if e.kind == KIND_DECODE]
    log(f"{tag}: launches {launches}; flash_attention on the tensor-core "
        f"kernel {wgmma}, ssd_fused on the tensor-core kernel {ssd_tc}")
    for name, want in _expected_launches(cfg).items():
        if launches[name] != want:
            raise AssertionError(f"the prefill launched {name} "
                                 f"{launches[name]} times, expected one per "
                                 f"layer that runs it ({want})")
    for name, tc in (("flash_attention", wgmma), ("ssd_fused", ssd_tc)):
        if tc != launches[name]:
            raise AssertionError(f"{launches[name]} {name} launches, {tc} "
                                 "of them on the tensor-core kernel: every "
                                 "bfloat16 call of the path should be")
    if tokens.shape != (SERVE_BATCH, SERVE_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {tokens.shape}")

    errs = {}
    for key, (c_args, c_kw) in cap.calls.items():
        name = key.split("/")[0]
        check = ssd_err if name == "ssd_fused" else flash_err
        err = check(_launch_counters()[name](*c_args, **c_kw),
                    _plain(name)(*c_args, **c_kw))
        log(f"{tag}: {key} on the path's own inputs "
            f"{[tuple(a.shape) for a in c_args if hasattr(a, 'shape')]} "
            f"{c_kw}: largest |kernel - plain| {err}")
        errs[name] = max(errs.get(name, 0.0), err)

    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.inference_mode():
        lg_k, _, _ = model.prefill(cfg, params, batch, max_len, cfg.dtype)
        with _Plain():
            lg_p, _, _ = model.prefill(cfg, params, batch, max_len,
                                       cfg.dtype)
    with _Plain():
        tokens_p = ServeEngine(cfg, params, scfg, device=dev).generate(
            {"tokens": prompts})
    if not (bool(torch.isfinite(lg_k).all()) and
            tuple(lg_k.shape) == (SERVE_BATCH, cfg.vocab)):
        raise AssertionError("kernel logits not finite or misshapen")
    d_max, d_mean = _logit_gap(lg_k, lg_p)
    top2 = lg_p.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    first_k, first_p = lg_k.argmax(-1).cpu().numpy(), \
        lg_p.argmax(-1).cpu().numpy()
    if not np.array_equal(first_k, tokens[:, 0]):
        raise AssertionError("the engine's first tokens differ from its "
                             "own prefill's")
    bad = (first_k != first_p) & (gap >= LOGIT_MAX_TOL)
    log(f"{tag}: last-token logits |kernel - plain| max {d_max:.6f}, mean "
        f"{d_mean:.6f} (tolerance {LOGIT_MAX_TOL} / {LOGIT_MEAN_TOL}); "
        f"plain top-2 gaps {np.round(gap, 4).tolist()}")
    if d_max > LOGIT_MAX_TOL or d_mean > LOGIT_MEAN_TOL or bad.any():
        raise AssertionError("kernel and plain prefill disagree")
    agree = int((tokens == tokens_p).sum())
    log(f"{tag}: batch {SERVE_BATCH} x prompt {SERVE_PROMPT} + "
        f"{SERVE_NEW} new tokens; prefill {pre_ms[0]:.3f} ms, "
        f"decode median {float(np.median(dec_ms)):.3f} ms/token "
        f"(min {min(dec_ms):.3f}, max {max(dec_ms):.3f}, "
        f"{len(dec_ms)} steps); peak memory "
        f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB live "
        f"before); first tokens equal {int((first_k == first_p).sum())}"
        f"/{SERVE_BATCH}; kernel and plain generations agree on "
        f"{agree}/{tokens.size} tokens")
    if cfg.meta_tokens:
        _continuation(cfg, params, dev, args.seed, tag)

    # where the serving time goes on the device: kernel time by name under
    # torch.profiler, for one prefill and for 8 decode steps
    with torch.inference_mode():
        pre = _device_profile(lambda: model.prefill(
            cfg, params, batch, max_len, cfg.dtype))
        lg, caches, index = model.prefill(cfg, params, batch, max_len,
                                          cfg.dtype)
        tok = [lg.argmax(-1)[:, None]]

        def decode(n=8):
            for t in range(n):
                lg_t, _ = model.decode_step(cfg, params, tok[0], caches,
                                            index + t)
                tok[0] = lg_t.argmax(-1)[:, None]
        dec = _device_profile(decode)
    for name, (wall, busy, top), per in (("prefill", pre, 1),
                                         ("decode", dec, 8)):
        if busy is None:
            log(f"{tag} profile {name}: device time not measured (the "
                "profiler saw no CUDA kernel)")
            continue
        log(f"{tag} profile {name}: device kernels {busy / per:.3f} ms per "
            f"step, host wall {wall / per:.3f} ms per step under the "
            f"profiler; largest: " + "; ".join(
                f"{n} {ms / per:.3f} ms x{c // per}" for n, ms, c in top))
    return launches, errs, cap.calls


def _logit_gap(a, b):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def _continuation(cfg, params, dev, seed, tag):
    """prefill(N - 1) + one decode step against prefill(N) on the card,
    at a prompt whose meta + text positions pass the attention window."""
    import numpy as np
    import torch

    from repro_torch.models import model

    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (CONT_BATCH, CONT_PROMPT)), device=dev)
    max_len = cfg.meta_tokens + CONT_PROMPT
    with torch.inference_mode():
        lg_full, _, _ = model.prefill(cfg, params, {"tokens": toks},
                                      max_len, cfg.dtype)
        _, caches, idx = model.prefill(cfg, params,
                                       {"tokens": toks[:, :-1]}, max_len,
                                       cfg.dtype)
        lg, _ = model.decode_step(cfg, params, toks[:, -1:], caches, idx)
    d_max, d_mean = _logit_gap(lg, lg_full)
    log(f"{tag}: continuation at batch {CONT_BATCH}, {cfg.meta_tokens} meta"
        f" + {CONT_PROMPT} prompt positions: prefill(N-1) + decode vs "
        f"prefill(N) logits max {d_max:.6f}, mean {d_mean:.6f}")
    if not bool(torch.isfinite(lg).all()) or d_max > LOGIT_MAX_TOL or \
            d_mean > LOGIT_MEAN_TOL:
        raise AssertionError("decode does not continue the prefill")


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; return (host wall ms, summed device
    kernel ms or None when the profiler saw none, the ten kernels with the
    most device time as (name, ms, launches))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not kern:
        return wall, None, []
    kern.sort(key=lambda e: -e.self_device_time_total)
    return (wall, sum(e.self_device_time_total for e in kern) / 1e3,
            [(e.key[:48], e.self_device_time_total / 1e3, e.count)
             for e in kern[:10]])


def kernel_names(source):
    """The ``__global__`` kernels of ``csrc/<source>.cu``, by name."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{source}.cu").read_text()
    return tuple(m.group(2) for m in re.finditer(
        r"__global__\s+void\s+((?:__\w+__\s*\([^)]*\)\s*)*)(\w+)\s*\(",
        text))


def _split_profile(fn, own, calls=20):
    """Run ``fn`` ``calls`` times under torch.profiler after a warm-up
    cycle of as many calls (the profiler misses the device activity of
    its first few hundred microseconds, so a window opened cold loses its
    first calls); return (device ms per call in the kernels named in
    ``own``, device ms per call in everything else — torch's copies,
    memsets and elementwise kernels —, own kernel launches seen, the other
    device activities' names with their counts)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    pat = re.compile(r"\b(" + "|".join(own) + r")\b")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):               # the warm-up cycle, then the one
            torch.cuda._sleep(SPIN_CYCLES)   # whose events are kept, each
            for _ in range(calls):       # behind a 1 ms spin kernel
                fn()
            torch.cuda.synchronize()
            prof.step()
    own_us = other_us = 0.0
    launches, others = 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name \
                or e.name.startswith("ProfilerStep"):
            continue                     # the spin and the step's own span
        us = e.time_range.elapsed_us()
        if pat.search(e.name):
            own_us += us
            launches += 1
        else:
            other_us += us
            key = e.name[:40]
            others[key] = others.get(key, 0) + 1
    return own_us / 1e3 / calls, other_us / 1e3 / calls, launches, others


SPIN_CYCLES = 2_000_000   # torch.cuda._sleep: about 1 ms of the card
TRACE_CALLS = 10_000
TRACE_BATCH = 50          # calls between synchronisations, outside a call
DETECT_CALLS = 2_000      # iqr_detect synchronises inside every call


def _trace(steps, calls=TRACE_CALLS):
    """Host time of each step of a wrapper call: ``steps`` is a list of
    (name, fn) run in order on one state dict, ``time.perf_counter_ns``
    read between steps, ``calls`` times with nothing synchronised inside
    a call (the queue is drained every TRACE_BATCH calls, outside them, so
    a launch never waits for a full queue). Returns (mean ns per call,
    {step: mean ns})."""
    import torch
    tick = time.perf_counter_ns
    total = [0] * len(steps)
    for _ in range(0, calls, TRACE_BATCH):
        torch.cuda.synchronize()
        for _ in range(TRACE_BATCH):
            st = {}
            t = tick()
            for i, (_, fn) in enumerate(steps):
                fn(st)
                u = tick()
                total[i] += u - t
                t = u
    torch.cuda.synchronize()
    per = {name: total[i] / calls for i, (name, _) in enumerate(steps)}
    return sum(per.values()), per


_P, _I, _L, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                   ctypes.c_longlong)
C_ARGS = {"rolling_stats": [_P, _LL, _LL, _P, _P],
          "binstats_flat": [_P, _P, _P, _L, _I, _I, _P, _P],
          "binstats_ts": [_P, _P, _P, _L, _I, _I, ctypes.c_float, _P, _P,
                          _P]}
TS_SMEM_MAX = 227 * 1024   # csrc/binstats.cu: the one-cluster table limit


def _rolling_steps(x, window, variant):
    """The rolling wrapper's host steps. ``op``: today's (the C++
    operator does the checks, the allocation, the stream and the launch);
    ``ctypes``: the same C entry through ctypes with lean Python steps (a
    cached typed function, the raw stream handle, a cast only when
    needed); ``before``: the earlier ctypes wrapper's (its checks and
    cast, ``check_tensor``, the locked library lookup, a
    ``torch.cuda.Stream`` object)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.rolling import ops as ro

    if variant == "op":
        def checks(st):
            if not (isinstance(x, torch.Tensor) and x.device.type == "cuda"
                    and type(window) is int):
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = ro._operator()

        def call(st):
            st["out"] = st["op"](x, window)
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        ro._check_args(x, window)
        if x.device.type == "cpu" or x.device.type != "cuda":
            raise AssertionError("not a CUDA tensor")
        if variant == "before":
            st["x"] = x.to(torch.float32).contiguous()
            check_tensor(st["x"], "x", torch.float32, 1, x.device)
        else:
            st["x"] = (x if x.dtype == torch.float32 and x.is_contiguous()
                       else x.to(torch.float32).contiguous())

    def alloc(st):
        st["out"] = torch.empty((x.shape[0], 2), dtype=torch.float32,
                                device=x.device)

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = lib.rolling_stats
        else:
            st["fn"] = _build.function("ops", "rolling_stats",
                                       C_ARGS["rolling_stats"])

    def stream(st):
        st["s"] = (torch.cuda.current_stream(x.device).cuda_stream
                   if variant == "before" else stream_ptr(x.device))

    def launch(st):
        st["code"] = st["fn"](st["x"].data_ptr(), x.shape[0], int(window),
                              st["out"].data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], "rolling_stats")
    return [("checks", checks), ("alloc", alloc), ("lookup", lookup),
            ("stream", stream), ("binding+launch", launch),
            ("result check", done)]


def _binstats_steps(args, flat, variant):
    """The binstats wrappers' host steps, as :func:`_rolling_steps`.
    ``before`` also replays the earlier wrapper's scratch allocations, its
    order flag zeroed (``torch.zeros``) and read back with ``.item()`` in
    the flat form, and its ``out[0]`` view for 1-D values; like the others
    it calls today's C entries, which launch one kernel where the earlier
    ones launched a memset and two kernels (flat) or three kernels
    (timestamp), so its binding+launch step reads low here."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.binstats import ops as bs

    if flat:
        seg, values, n_seg, valid = args
        lead, size = seg, n_seg
    else:
        (lead, values, valid), kw = args
        size = kw["n_bins"]
        inv = float(np.float32(size / kw["total_ns"]))
    symbol = "binstats_flat" if flat else "binstats_ts"
    lead_dtype = torch.int32 if flat else torch.float32

    if variant == "op":
        def checks(st):
            if values.device.type != "cuda":
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = bs._operator(symbol)

        def call(st):
            st["out"] = (st["op"](seg, values, n_seg, valid) if flat else
                         st["op"](lead, values, valid,
                                  float(kw["total_ns"]), size))
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        if size < 1 or values.device.type == "cpu" or \
                values.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        dev = values.device
        if variant == "ctypes":          # one combined test
            nd, n = values.dim(), values.shape[-1]
            if not (nd in (1, 2) and values.dtype == torch.float32
                    and values.is_contiguous() and lead.dtype == lead_dtype
                    and lead.dim() == 1 and lead.is_contiguous()
                    and lead.shape[0] == n and lead.device == dev
                    and valid.dtype == torch.bool and valid.dim() == 1
                    and valid.is_contiguous() and valid.shape[0] == n
                    and valid.device == dev):
                raise AssertionError("arguments")
            st["mn"] = (1 if nd == 1 else values.shape[0]), n
            return
        vals, _ = bs._as_2d(values)
        check_tensor(vals, "values", torch.float32, 2, dev)
        check_tensor(lead, "lead", lead_dtype, 1, dev)
        check_tensor(valid, "valid", torch.bool, 1, dev)
        if lead.shape[0] != vals.shape[1] or valid.shape[0] != vals.shape[1]:
            raise AssertionError("shapes")
        st["mn"] = vals.shape

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = getattr(lib, symbol)
        else:
            st["fn"] = _build.function("ops", symbol, C_ARGS[symbol])

    def alloc(st):
        m, dev = st["mn"][0], values.device
        before = variant == "before"
        if before and flat:
            st["offsets"] = torch.empty(size + 1, dtype=torch.int32,
                                        device=dev)
            st["err"] = torch.zeros(1, dtype=torch.int32, device=dev)
        if not flat and (before or size * (1 + 4 * m) * 4 > TS_SMEM_MAX):
            st["cnt"] = torch.empty(size, dtype=torch.int32, device=dev)
        shape = ((size, bs.STATS) if values.dim() == 1 and not before
                 else (m, size, bs.STATS))
        st["out"] = torch.empty(shape, dtype=torch.float32, device=dev)

    def stream(st):
        st["s"] = (torch.cuda.current_stream(values.device).cuda_stream
                   if variant == "before" else stream_ptr(values.device))

    def launch(st):
        out = st["out"]
        m, n = st["mn"]
        if flat:
            st["code"] = st["fn"](lead.data_ptr(), values.data_ptr(),
                                  valid.data_ptr(), n, size, m,
                                  out.data_ptr(), st["s"])
        else:
            cnt = st.get("cnt")
            st["code"] = st["fn"](lead.data_ptr(), values.data_ptr(),
                                  valid.data_ptr(), n, m, size, inv,
                                  None if cnt is None else cnt.data_ptr(),
                                  out.data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], symbol)
        if variant == "before" and flat:
            int(st["err"].item())
        if variant == "before" and values.dim() == 1:
            st["out"][0]
    sync = " + .item() sync" if variant == "before" and flat else ""
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check" + sync, done)]


def _histbin_steps(args, variant):
    """The histbin_flat wrapper's host steps, as :func:`_rolling_steps`:
    ``op`` today's (the C++ operator), ``ctypes`` the same C entry with
    lean Python steps, ``before`` the earlier ctypes wrapper's steps replayed
    (``_as_2d``, three ``check_tensor`` calls, the locked library lookup,
    ``torch.empty``, the raw stream, the call, the result check and the
    ``out[0]`` view of 1-D values)."""
    import torch

    from repro_torch.core.reducers import N_BUCKETS
    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.binstats import ops as bs

    seg, values, n_seg, valid = args
    if variant == "op":
        def checks(st):
            if values.device.type != "cuda":
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = bs._operator("histbin_flat")

        def call(st):
            st["out"] = st["op"](seg, values, n_seg, valid)
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        if n_seg < 1 or values.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        vals, _ = bs._as_2d(values)
        if variant == "before":
            check_tensor(vals, "values", torch.float32, 2, values.device)
            check_tensor(seg, "seg", torch.int32, 1, values.device)
            check_tensor(valid, "valid", torch.bool, 1, values.device)
        elif not (vals.is_contiguous() and seg.is_contiguous()
                  and valid.is_contiguous()):
            raise AssertionError("arguments")
        if seg.shape[0] != vals.shape[1] or valid.shape[0] != vals.shape[1]:
            raise AssertionError("shapes")
        st["mn"] = vals.shape

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = lib.histbin_flat
        else:
            st["fn"] = _build.function("ops", "histbin_flat",
                                       C_ARGS["binstats_flat"])

    def alloc(st):
        st["out"] = torch.empty((st["mn"][0], n_seg, N_BUCKETS),
                                dtype=torch.float32, device=values.device)

    def stream(st):
        st["s"] = stream_ptr(values.device)

    def launch(st):
        m, n = st["mn"]
        st["code"] = st["fn"](seg.data_ptr(), values.data_ptr(),
                              valid.data_ptr(), n, n_seg, m,
                              st["out"].data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], "histbin_flat")
        if variant == "before" and values.dim() == 1:
            st["out"][0]
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check", done)]


def _iqr_steps(scores, occ, variant):
    """The iqr_fences wrapper's host steps, as :func:`_rolling_steps`:
    ``op`` today's (the C++ operator, and the result dict with its six
    named 0-d views from one ``unbind``), ``before`` the earlier ctypes
    wrapper's steps replayed against the same C entry (its checks, two
    ``check_tensor`` calls, the typed-function lookup, four
    ``torch.empty``, the raw stream, the call, the result check and the
    result dict with its six named 0-d views)."""
    import ctypes as ct

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.iqr import ops as iq

    if variant == "op":
        def checks(st):
            if not (isinstance(scores, torch.Tensor)
                    and scores.device.type == "cuda"):
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = iq._operator()

        def call(st):
            st["out"] = st["op"](scores, occ, 1.5)

        def result(st):
            iq._result(*st["out"])
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call), ("result dict", result)]

    f64 = scores.dtype == torch.float64
    symbol, key = (("iqr_fences_f64", ct.c_double) if f64
                   else ("iqr_fences", ct.c_float))

    def checks(st):
        if scores.dim() != 1 or scores.shape[0] < 1:
            raise AssertionError("shape")
        if scores.device.type == "cpu" or scores.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        check_tensor(scores, "scores", scores.dtype, 1, scores.device)
        check_tensor(occ, "occupied", torch.bool, 1, scores.device)
        if occ.shape[0] != scores.shape[0] or scores.shape[0] >= 1 << 30:
            raise AssertionError("shapes")

    def lookup(st):
        st["fn"] = _build.function("ops", symbol, [_P, _P, _I, _I, key, _P,
                                                   _P, _P, _P, _P])

    def alloc(st):
        n = scores.shape[0]
        n_p = iq.next_pow2(n)
        nbytes = _build.load("ops").iqr_scratch_bytes(
            n_p, scores.element_size())
        dev = scores.device
        st["n_p"] = n_p
        st["scratch"] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                    device=dev)
        st["srt"] = torch.empty(n, dtype=scores.dtype, device=dev)
        st["flags"] = torch.empty(n, dtype=torch.int32, device=dev)
        st["stats"] = torch.empty(8, dtype=scores.dtype, device=dev)

    def stream(st):
        st["s"] = stream_ptr(scores.device)

    def launch(st):
        st["code"] = st["fn"](scores.data_ptr(), occ.data_ptr(),
                              scores.shape[0], st["n_p"], 1.5,
                              st["scratch"].data_ptr(), st["srt"].data_ptr(),
                              st["flags"].data_ptr(), st["stats"].data_ptr(),
                              st["s"])

    def done(st):
        _build.check(st["code"], "iqr_fences")
        out = {"sorted": st["srt"], "flags": st["flags"],
               "stats": st["stats"]}
        out.update({name: st["stats"][i]
                    for i, name in enumerate(iq.STAT_NAMES)})
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check and dict", done)]


def _iqr_detect_steps(scores_np, bounds, dev):
    """``core.anomaly.iqr_detect``'s steps at the main path's call: host
    prep, the upload, the kernel call, the two device-to-host reads (the
    stats, then the flags) and the host ranking."""
    import numpy as np
    import torch

    from repro_torch.kernels.iqr import iqr_fences

    def prep(st):
        st["scores"] = s = np.asarray(scores_np, np.float64)
        occupied = s != 0.0
        st["fenced"] = occupied if occupied.any() else np.ones_like(occupied)

    def upload(st):
        st["s_t"] = torch.as_tensor(st["scores"], dtype=torch.float64,
                                    device=dev)
        st["o_t"] = torch.as_tensor(st["fenced"], device=dev)

    def call(st):
        st["out"] = iqr_fences(st["s_t"], st["o_t"], k_factor=1.5)

    def read_stats(st):
        st["q"] = [float(x) for x in st["out"]["stats"][:5].cpu()]

    def read_flags(st):
        st["flags"] = st["out"]["flags"].cpu().numpy().astype(bool)

    def rank(st):
        s, lo, hi = st["scores"], st["q"][3], st["q"][4]
        flags = st["flags"] | (~st["fenced"] & (s > hi))
        exceed = np.where(flags, np.abs(s - np.clip(s, lo, hi)), -1.0)
        top = np.argsort(-exceed, kind="stable")[:min(5, int(flags.sum()))]
        np.stack([bounds[top], bounds[top + 1]], axis=1).astype(np.int64)
    return [("host prep", prep), ("upload", upload),
            ("kernel call", call), ("stats read (sync)", read_stats),
            ("flags read", read_flags), ("host ranking", rank)]


def phase_host_trace(shapes):
    """Host time per step of the rolling_stats, binstats, binstats_flat,
    histbin_flat and iqr_fences wrappers at their path shapes: today's
    steps (the C++ operator), the same C entries through lean ctypes steps
    (not for iqr_fences), and the earlier ctypes wrapper's steps replayed,
    beside the whole wrapper call timed the same way; then iqr_detect at
    the main path's call, step by step."""
    import numpy as np

    import repro_torch.kernels as K
    from repro_torch.kernels.binstats import binstats_flat
    from repro_torch.kernels.histbin import histbin_flat

    x, window = shapes["rolling_stats"]
    (ts, vals, valid), kw = shapes["binstats"]
    flat = shapes["binstats_flat"]
    hflat = shapes["histbin_flat"]
    cases = (
        ("rolling_stats", f"{x.shape[0]} values, window {window}",
         lambda st: K.rolling_stats(x, window=window),
         lambda variant: _rolling_steps(x, window, variant)),
        ("binstats", f"{ts.shape[0]} events, {kw['n_bins']} bins",
         lambda st: K.binstats(ts, vals, valid, **kw),
         lambda variant: _binstats_steps(shapes["binstats"], False,
                                         variant)),
        ("binstats_flat", f"{flat[0].shape[0]} rows, "
         f"{tuple(flat[1].shape)} values, {flat[2]} segments",
         lambda st: binstats_flat(*flat),
         lambda variant: _binstats_steps(flat, True, variant)),
        ("histbin_flat", f"{hflat[0].shape[0]} rows, "
         f"{tuple(hflat[1].shape)} values, {hflat[2]} segments",
         lambda st: histbin_flat(*hflat),
         lambda variant: _histbin_steps(hflat, variant)),
    )
    (scores, occ), _ = shapes["iqr_fences"]
    cases += (
        ("iqr_fences", f"{scores.shape[0]} float64 scores",
         lambda st: K.iqr_fences(scores, occ),
         lambda variant: _iqr_steps(scores, occ, variant)),)
    labels = {"op": "today's steps (C++ operator)",
              "ctypes": "lean ctypes steps",
              "before": "the earlier wrapper's steps replayed"}
    out = {}
    for name, what, call, steps in cases:
        res = {"call": _trace([("call", call)])[0]}
        parts = []
        variants = (("op", "before") if name == "iqr_fences"
                    else ("op", "ctypes", "before"))
        for variant in variants:
            label = labels[variant]
            total, per = res[variant] = _trace(steps(variant))
            parts.append(f"{label} {total / 1e3:.2f} us = " + ", ".join(
                f"{k} {v / 1e3:.2f}" for k, v in per.items()))
        out[name] = res
        log(f"host trace {name} ({what}), mean over {TRACE_CALLS} calls: "
            f"wrapper call {res['call'] / 1e3:.2f} us; " + "; ".join(parts))
    # iqr_detect at the main path's call: every call synchronises
    from repro_torch.core import anomaly
    s_np = scores.cpu().numpy()
    bounds = np.arange(s_np.shape[0] + 1, dtype=np.int64) * 10_000_000
    whole, _ = _trace([("call", lambda st: anomaly.iqr_detect(
        s_np, boundaries=bounds))], DETECT_CALLS)
    total, per = _trace(_iqr_detect_steps(s_np, bounds, scores.device),
                        DETECT_CALLS)
    out["iqr_detect"] = {"call": whole, "steps": (total, per)}
    log(f"host trace iqr_detect ({s_np.shape[0]} scores), mean over "
        f"{DETECT_CALLS} calls: whole call {whole / 1e3:.2f} us; steps "
        f"{total / 1e3:.2f} us = " + ", ".join(
            f"{k} {v / 1e3:.2f}" for k, v in per.items()))
    return out


def _plain(name):
    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd
    return {"binstats_flat": bs.binstats_flat_plain,
            "binstats": bs.binstats_plain,
            "histbin_flat": hb.histbin_flat_plain,
            "histbin": hb.histbin_plain,
            "iqr_fences": iq.iqr_fences_plain,
            "ssd_fused": sd.ssd_fused_plain,
            "flash_attention": fa.flash_attention_plain,
            "rolling_stats": ro.rolling_stats_plain}[name]


def _ts_inputs(flat_args, n_bins):
    """Timestamp-form inputs at the main path's row count and bin count
    (the timestamp forms are not on the main path)."""
    import torch
    seg, vals, _, valid = flat_args
    gen = torch.Generator(device=vals.device).manual_seed(5)
    ts = torch.rand(seg.shape[0], generator=gen, device=vals.device) * 1.2e11
    return ((ts.contiguous(), vals, valid),
            {"total_ns": 1.2e11, "n_bins": n_bins})


def phase_delta(args, work):
    import numpy as np

    from repro_torch.core import (TraceStore, VariabilityPipeline,
                                  append_rank_db, generate_synthetic,
                                  trace_remainder, truncate_trace,
                                  write_rank_db)

    ds = generate_synthetic(_spec(args))
    t0 = int(min(tr.kernels.start.min() for tr in ds.traces))
    cutoff = t0 + int(0.9 * args.duration * 1e9)
    root = os.path.join(work, "delta")
    os.makedirs(root)
    paths = [os.path.join(root, f"rank{tr.rank}.sqlite") for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        write_rank_db(p, truncate_trace(tr, cutoff))
    store = os.path.join(root, "store")
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    pipe.run(paths, store)
    for tr, p in zip(ds.traces, paths):
        append_rank_db(p, trace_remainder(tr, cutoff))
    delta = pipe.append(paths, store)
    if delta.aggregation.partial_hits < 1:
        raise AssertionError("the delta served no shard from the cache")
    cold_dir = os.path.join(root, "cold")
    shutil.copytree(store, cold_dir)
    cs = TraceStore(cold_dir)
    cs.clear_summaries()
    cs.clear_partials()
    cold = pipe.aggregate(cold_dir)
    if cold.partial_hits != 0:
        raise AssertionError("the cold run read cached partials")
    a, b = delta.aggregation, cold
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)
    log(f"delta: {len(a.recomputed_shards)} shards recomputed, "
        f"{a.partial_hits} from the partial cache; delta == cold bitwise "
        f"({len(b.recomputed_shards)} shards cold)")


# the layer_norm family of the synthetic name table (ids congruent mod 21),
# the one the diff phase slows down
SLOW_IDS = (3, 24, 45)
SLOW_FAMILY = "layer_norm"
DIFF_INTERVAL_NS = 10_000_000
SERVICE_CLIENTS = 16


def _path_launches(counters):
    return {k: counters[k].launches
            for k in ("binstats_flat", "histbin_flat", "iqr_fences")}


def _need_launches(phase, launches, exact=None):
    """Raise unless every kernel of the analysis path launched (and, for
    ``exact``, launched exactly that many times)."""
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{phase}: the path never launched {name}")
        if exact is not None and name in exact and n != exact[name]:
            raise AssertionError(f"{phase}: {name} launched {n} times, "
                                 f"expected {exact[name]}")


def _bare_copy(src, dst):
    """A copy of a store's manifest and shard files, without its caches."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name == "manifest.json" or (name.startswith("shard_")
                                       and name.endswith(".npz")):
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))


def _assert_diff_scores_close(got, want):
    """Two diff reports of one pair: the same ranked groups, match kinds,
    verdicts, counts and top bins; float scores within RTOL."""
    import numpy as np
    if [g.name_a for g in got.groups] != [g.name_a for g in want.groups]:
        raise AssertionError("the two backends rank the groups apart")
    for g, w in zip(got.groups, want.groups):
        if ((g.name_b, g.matched_via, g.regressed, g.count_a, g.count_b,
             g.top_bins) != (w.name_b, w.matched_via, w.regressed,
                             w.count_a, w.count_b, w.top_bins)):
            raise AssertionError(f"group {g.name_a} differs")
        np.testing.assert_array_equal(g.top_windows, w.top_windows)
        for f in ("mean_a", "mean_b", "mean_ratio", "p99_a", "p99_b",
                  "p99_ratio", "shift_octaves", "spread_octaves",
                  "geo_ratio"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(g.bin_shift, w.bin_shift, rtol=RTOL,
                                   atol=1e-12)


def phase_diff(args, work, card):
    import dataclasses
    import itertools

    import torch

    from repro_torch.core import (Query, VariabilityPipeline, distributed,
                                  generate_synthetic, inject_slowdown,
                                  normalize_kernel_name, write_synthetic_dbs)

    store_a = os.path.join(work, "store")
    store_b = os.path.join(work, "store_b")
    t0 = time.perf_counter()
    ds = inject_slowdown(generate_synthetic(
        dataclasses.replace(_spec(args), name_variant=1)), 1.5, SLOW_IDS)
    paths = write_synthetic_dbs(ds, os.path.join(work, "dbs_b"))
    del ds
    gen = VariabilityPipeline(_cfg(args, "torch")).generate(paths, store_b)
    log(f"diff: store B (name variant 1, {SLOW_FAMILY} ids {SLOW_IDS} "
        f"x1.5) built by phase 1 in {time.perf_counter() - t0:.3f}s "
        f"({gen.joined_rows} joined rows, {gen.n_shards} shards)")
    base = Query(metrics=("k_stall",), interval_ns=DIFF_INTERVAL_NS)
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    counters = _launch_counters()
    seq = itertools.count()
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat")),
                  key=lambda name, kwargs: (name, next(seq)))
    try:
        _zero(counters)
        t = time.perf_counter()
        cold = pipe.diff(store_a, store_b, query=base)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
        launches = _path_launches(counters)
    finally:
        cap.close()
    # every wrapper call in order, side A's first
    calls = [(name, a) for (name, _), (a, _) in
             sorted(cap.calls.items(), key=lambda kv: kv[0][1])]
    n_seg = [a[2] for name, a in calls if name == "histbin_flat"]
    log(f"diff: cold torch diff {cold_s:.3f}s, launches {launches}, "
        f"device segments per side {n_seg}; {cold.provenance()} [{card}]")
    del launches["iqr_fences"]          # a diff fences nothing
    _need_launches("diff", launches,
                   exact={"binstats_flat": 2, "histbin_flat": 2})
    if cold.verdict != "regressed" or cold.from_cache:
        raise AssertionError(f"diff: verdict {cold.verdict}, from cache "
                             f"{cold.from_cache}")
    top = cold.groups[:len(SLOW_IDS)]
    if not all(SLOW_FAMILY in normalize_kernel_name(g.name_a) for g in top):
        raise AssertionError("diff: the injected family is not ranked "
                             f"first: {[g.name_a for g in top]}")
    if {g.name_a for g in cold.regressions()} != {g.name_a for g in top}:
        raise AssertionError("diff: regressions beyond the injected family")
    log("diff: verdict regressed, top " + ", ".join(
        f"{g.name_a} geo x{g.geo_ratio:.4f} mean x{g.mean_ratio:.4f} "
        f"p99 x{g.p99_ratio:.4f}" for g in top))
    # the kernels on side B's own inputs against their plain versions
    last = dict(calls)
    errs = {"binstats_flat": moments_err(
                distributed.binstats_flat(*last["binstats_flat"]),
                _plain("binstats_flat")(*last["binstats_flat"])),
            "histbin_flat": hist_err(
                distributed.histbin_flat(*last["histbin_flat"]),
                _plain("histbin_flat")(*last["histbin_flat"]))}
    del cap, calls, last
    torch.cuda.empty_cache()
    log(f"diff: kernels on side B's inputs, largest |kernel - plain|: "
        f"{errs}")
    self_rep = pipe.diff(store_a, store_a, query=base)
    if self_rep.verdict != "pass":
        raise AssertionError("diff: a self-diff did not pass")
    exact_pipe = VariabilityPipeline(dataclasses.replace(
        _cfg(args, "serial"), use_summary_cache=False))
    t = time.perf_counter()
    exact = exact_pipe.diff(store_a, store_b, query=base)
    exact_s = time.perf_counter() - t
    if exact.verdict != cold.verdict:
        raise AssertionError("diff: serial and torch verdicts differ")
    _assert_diff_scores_close(cold, exact)
    log(f"diff: serial diff {exact_s:.3f}s: same verdict, same "
        f"{len(exact.groups)} ranked groups, scores within rtol {RTOL}")
    for name in os.listdir(store_b):
        if name.startswith("diff_") and name.endswith(".json"):
            os.remove(os.path.join(store_b, name))
    _zero(counters)
    t = time.perf_counter()
    warm = pipe.diff(store_a, store_b, query=base)
    warm_s = time.perf_counter() - t
    if warm.from_cache or warm.shard_reads_a or warm.shard_reads_b:
        raise AssertionError(f"diff: the warm repeat read shards "
                             f"({warm.provenance()})")
    if any(_path_launches(counters).values()):
        raise AssertionError("diff: the warm repeat launched a kernel")
    t = time.perf_counter()
    cached = pipe.diff(store_a, store_b, query=base)
    cached_s = time.perf_counter() - t
    if not cached.from_cache or cached.verdict != cold.verdict:
        raise AssertionError("diff: the third call did not load the report")
    log(f"diff: seconds cold {cold_s:.3f}, warm {warm_s:.3f} "
        f"({warm.provenance()}), cached {cached_s:.3f} "
        f"({cached.provenance()}); self-diff pass [{card}]")
    return errs


def _service_queries(man):
    """Eight distinct queries: no grouping and each group column, moments
    alone and with the quantile sketch, mean / p95 / p99 scores, 10 ms /
    100 ms / 1 s bins and one time window. The second is the main
    phase's own query (a summary on the store already)."""
    span = int(man.t_end - man.t_start)
    window = [int(man.t_start + span // 3), int(man.t_start + span // 2)]
    ms = 1_000_000
    return [
        {"metrics": ["k_stall"], "interval_ns": 10 * ms},
        {"metrics": list(METRICS), "group_by": "k_device",
         "reducers": ["moments", "quantile"], "anomaly_score": "p99",
         "interval_ns": 10 * ms},
        {"metrics": ["m_duration"], "group_by": "m_kind",
         "reducers": ["moments", "quantile"], "anomaly_score": "p95",
         "interval_ns": 100 * ms},
        {"metrics": ["k_stall"], "group_by": "src_rank",
         "interval_ns": 1000 * ms},
        {"metrics": ["k_stall"], "group_by": "k_name",
         "reducers": ["moments", "quantile"], "anomaly_score": "p99",
         "interval_ns": 1000 * ms},
        {"metrics": ["m_bytes"], "group_by": "m_kind",
         "time_window": window, "interval_ns": 100 * ms},
        {"metrics": ["k_stall"], "reducers": ["quantile"],
         "anomaly_score": "p99", "interval_ns": 100 * ms},
        {"metrics": ["k_stall", "m_duration"], "group_by": "k_device",
         "interval_ns": 1000 * ms},
    ]


def _same_answer(got, want):
    """A rendered torch answer against the serial one: counts and fence
    flags exactly, min/max in float32, means within RTOL."""
    import numpy as np
    if (got["n_samples"], got["n_bins"], got.get("anomalous_bins")) != \
            (want["n_samples"], want["n_bins"], want.get("anomalous_bins")):
        raise AssertionError(f"service: {got['query']} differs in "
                             "samples, bins or flags")
    if set(got["groups"]) != set(want["groups"]):
        raise AssertionError(f"service: {got['query']} differs in groups")
    for gk, cells in want["groups"].items():
        for m, cell in cells.items():
            mine = got["groups"][gk][m]
            if mine["count"] != cell["count"] or any(
                    np.float32(mine[f]) != np.float32(cell[f])
                    for f in ("min", "max")):
                raise AssertionError(f"service: {got['query']} group {gk} "
                                     f"{m} differs")
            np.testing.assert_allclose(mine["mean"], cell["mean"],
                                       rtol=RTOL)


def phase_service(args, work, card):
    import threading

    import torch

    from repro_torch.core import Query, TraceStore, VariabilityPipeline
    from repro_torch.serve import QueryClient, QueryService, ServiceConfig

    store = os.path.join(work, "store")
    specs = _service_queries(TraceStore(store).read_manifest())
    exact_dir = os.path.join(work, "service_exact")
    _bare_copy(store, exact_dir)
    counters = _launch_counters()
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    n = SERVICE_CLIENTS
    bodies, walls, errors = [None] * n, [0.0] * n, []
    _zero(counters)
    svc = pipe.serve(store, port=0, tick_ms=50.0)
    try:
        client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
        if not client.wait_healthy(timeout_s=30.0):
            raise AssertionError("service: not healthy")
        start = threading.Barrier(n)

        def ask(i):
            try:
                start.wait(60)
                t = time.perf_counter()
                bodies[i] = client.query_raw([specs[i % len(specs)]])
                walls[i] = time.perf_counter() - t
            except BaseException as e:   # noqa: BLE001 — raised below
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = _path_launches(counters)
        stats = client.stats()
    finally:
        svc.stop()
    if errors:
        raise AssertionError(f"service: {errors}")
    widths = [b["tick"]["fused_width"] for b in bodies]
    hits = sum(bool(b["results"][0].get("inflight_hit")
                    or b["results"][0]["cache_hit"]) for b in bodies)
    log(f"service: {n} clients x 1 query ({len(specs)} distinct) in "
        f"{wall:.3f}s; request wall s {sorted(round(w, 3) for w in walls)};"
        f" fused widths {widths}; in-flight or summary hits {hits}; ticks "
        f"{stats['ticks']}, tick p50/p95/p99 {stats['tick_p50_ms']:.1f} / "
        f"{stats['tick_p95_ms']:.1f} / {stats['tick_p99_ms']:.1f} ms; "
        f"launches {launches} [{card}]")
    _need_launches("service", launches)
    if max(widths) < 2:
        raise AssertionError("service: no tick fused two requests")
    if hits < 1:
        raise AssertionError("service: no in-flight or summary hit")
    exact = QueryService(exact_dir, ServiceConfig(
        backend="serial", device="cuda", tick_ms=1.0,
        summary_budget_bytes=None))
    t = time.perf_counter()
    p = exact.submit([Query.from_spec(s) for s in specs])
    if exact.drain_once(block_s=0.0) != 1 or p.error is not None:
        raise AssertionError(f"service: the serial service failed "
                             f"{p.error}")
    for i, b in enumerate(bodies):
        _same_answer(b["results"][0], p.results[i % len(specs)])
    log(f"service: every answer == the serial service's on a copy of the "
        f"store (counts, flags exact; min/max in float32; means rtol "
        f"{RTOL}); serial tick {time.perf_counter() - t:.3f}s")


def _shards_equal(a, b, n):
    """Names of the first ``n`` shard files that differ between two
    stores (byte for byte)."""
    import filecmp
    names = [f"shard_{s:06d}.npz" for s in range(n)]
    _, mismatch, missing = filecmp.cmpfiles(a, b, names, shallow=False)
    return mismatch + missing


def phase_stream(args, work, card):
    import numpy as np
    import torch

    from repro_torch.core import (PipelineConfig, TraceStore,
                                  VariabilityPipeline, append_rank_db,
                                  generate_synthetic, run_append,
                                  run_generation, trace_remainder,
                                  truncate_trace, write_rank_db)
    from repro_torch.serve import (DEFAULT_FENCE_QUERY, IngestConfig,
                                   QueryClient)

    root = os.path.join(work, "stream")
    ds = generate_synthetic(_spec(args))
    t0 = int(min(tr.kernels.start.min() for tr in ds.traces))
    ns = 1_000_000_000
    cutoff = t0 + 90 * ns
    # the rank DBs the plane tails, and a copy the same appends are
    # replayed on without the service
    paths, replay = ([os.path.join(root, sub, f"rank{tr.rank}.sqlite")
                      for tr in ds.traces] for sub in ("dbs", "replay"))
    for sub in ("dbs", "replay"):
        os.makedirs(os.path.join(root, sub))
    for tr, p, q in zip(ds.traces, paths, replay):
        write_rank_db(p, truncate_trace(tr, cutoff))
        shutil.copy2(p, q)
    store, replay_store = (os.path.join(root, d)
                           for d in ("store", "replay_store"))
    cfg = PipelineConfig(n_ranks=args.ranks, backend="torch", device="cuda",
                         anomaly_score="p99")
    pipe = VariabilityPipeline(cfg)
    pipe.generate(paths, store)
    run_generation(replay, replay_store, n_ranks=args.ranks)
    counters = _launch_counters()
    svc = pipe.stream(store, paths, ingest=IngestConfig(poll_ms=25.0))
    events, since, batches, replayed = [], 0, [], []
    try:
        client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
        _zero(counters)
        lo = cutoff
        for hi in (cutoff + 10 * ns, cutoff + 20 * ns, None):
            batch = [trace_remainder(tr, lo) if hi is None
                     else trace_remainder(truncate_trace(tr, hi), lo)
                     for tr in ds.traces]
            lo = hi
            for b, p in zip(batch, paths):
                append_rank_db(p, b)
            body = client.fences(since=since, timeout_s=120.0)
            if not body["events"]:
                raise AssertionError("stream: no fence event within the "
                                     "long poll")
            if not svc.ingestor.quiesce(timeout_s=300.0):
                raise AssertionError("stream: the plane did not catch up")
            got = list(body["events"])
            since = body["next_since"]
            while True:
                more = client.fences(since=since, timeout_s=0.2)
                if not more["events"]:
                    break
                got += more["events"]
                since = more["next_since"]
            batches.append(sum(e["ingest"]["rows_ingested"] for e in got))
            events += got
            for b, q in zip(batch, replay):
                append_rank_db(q, b)
            replayed.append(run_append(replay, replay_store).appended_rows)
        torch.cuda.synchronize()
        launches = _path_launches(counters)
        st = client.stats()["ingest"]
    finally:
        svc.stop()
    del ds
    log(f"stream: {len(events)} events over 3 batches (rows {batches}); "
        f"ingest ticks {st['ingest_ticks']}, rows {st['rows_ingested']}, "
        f"fence transitions {st['fence_transitions']}, errors "
        f"{st['errors']}; event_to_fence p50/p99 "
        f"{st['event_to_fence_p50_ms']:.1f} / "
        f"{st['event_to_fence_p99_ms']:.1f} ms; launches {launches} "
        f"[{card}]")
    if st["errors"]:
        raise AssertionError(f"stream: ingest errors {st['last_ingest']}")
    _need_launches("stream", launches)
    if batches != replayed or st["rows_ingested"] != sum(replayed):
        raise AssertionError(f"stream: ingested {batches} rows a batch, "
                             f"the same appends without the service "
                             f"{replayed}")
    n = TraceStore(replay_store).read_manifest().n_shards
    if TraceStore(store).read_manifest().n_shards != n:
        raise AssertionError("stream: shard count differs from the replay")
    differ = _shards_equal(store, replay_store, n)
    if differ:
        raise AssertionError(f"stream: shard files differ from the same "
                             f"appends without the service: {differ}")
    # delta == cold: the plane's fences against a cold torch run over a
    # cache-free copy of the same shards
    cold_dir = os.path.join(root, "cold")
    _bare_copy(store, cold_dir)
    streamed = svc.ingestor.fence_state().get(
        DEFAULT_FENCE_QUERY.cache_key(), ())
    cold = VariabilityPipeline(cfg).query(cold_dir, [DEFAULT_FENCE_QUERY])[0]
    mine = pipe.query(store, [DEFAULT_FENCE_QUERY])[0]
    if not mine.cache_hit or cold.cache_hit:
        raise AssertionError("stream: the plane left no summary, or the "
                             "cold copy had one")
    if tuple(int(i) for i in np.flatnonzero(cold.anomalies.flags)) != \
            streamed:
        raise AssertionError("stream: fence flags differ from a cold run")
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(mine.result.stats, f),
                                      getattr(cold.result.stats, f))
    np.testing.assert_array_equal(mine.result.reduced["quantile"].counts,
                                  cold.result.reduced["quantile"].counts)
    np.testing.assert_array_equal(mine.anomalies.top_windows,
                                  cold.anomalies.top_windows)
    # a from-scratch phase 1 of the final DBs, for the record: phase 1
    # never joins an already committed kernel with a memcpy appended
    # later, nor a kernel with a memcpy across a rank's range boundary
    fresh = os.path.join(root, "fresh")
    gen = run_generation(paths, fresh, n_ranks=args.ranks)
    rows = sum(int(np.load(os.path.join(store, f"shard_{s:06d}.npz"))[
        "k_start"].size) for s in range(n))
    log(f"stream: {sum(replayed)} rows ingested == the same appends "
        f"without the service; {n} shard files equal theirs byte for "
        f"byte; fences and moments == a cold torch run over the same "
        f"shards ({len(streamed)} flagged bins, top windows equal); a "
        f"from-scratch phase 1 of the final DBs holds {gen.joined_rows} "
        f"joined rows against the stream's {rows}, "
        f"{len(_shards_equal(store, fresh, n))} shard files apart")

def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_row(call, plain, library, out, inputs, ops, own,
             ops_per_s=FP32_OPS_PER_S, calls=20):
    """One row of the times phase: a wrapper call by CUDA events (what a
    caller sees, "ms") beside its one-call yardstick, then the device time
    of a call under torch.profiler (after a warm-up cycle) split into the
    row's own kernels (``own``, launched from its library) and the
    wrapper's other device work; the whole read twice, in turn. The bound
    is the larger of ``inputs`` read and ``out`` written once over the
    memory rate and ``ops`` over ``ops_per_s``."""
    nbytes = _nbytes(*inputs) + _nbytes(*out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    ev, lib, dev_ms, other_ms, seen = [], [], [], [], []
    for _ in range(2):
        ev.append(_time_ms(call))
        lib.append(None if library is None else _time_ms(library))
        d, o, k, others = _split_profile(call, own, calls)
        dev_ms.append(d)
        other_ms.append(o)
        seen.append(k)
    return {
        "ms": ev[0], "ms_again": ev[1], "device_ms": dev_ms[0],
        "device_ms_again": dev_ms[1], "other_device_ms": other_ms[0],
        "other_device_ms_again": other_ms[1], "own_launches": seen,
        "kernels_per_call": max(seen) / calls,
        "other_device_ops": others, "plain_ms": _time_ms(plain),
        "library_ms": lib[0], "library_ms_again": lib[1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
        "ops_ms": t_ops}


def iqr_row(fn, plain, scores, occ, kw=None):
    """``time_row`` of the iqr wrapper ``fn`` on (scores, occ): the plain
    version ``plain``, ``torch.quantile`` of the occupied scores as the
    yardstick, n log2 n comparisons as its operations."""
    import math

    import torch
    kw = kw or {}
    res = fn(scores, occ, **kw)
    n = scores.shape[0]
    q = torch.tensor([0.25, 0.75], dtype=scores.dtype, device=scores.device)
    occ_scores = scores[occ]
    return time_row(lambda: fn(scores, occ, **kw),
                    lambda: plain(scores, occ, **kw),
                    lambda: torch.quantile(occ_scores, q),
                    [res["sorted"], res["flags"], res["stats"]],
                    [scores, occ], n * max(math.log2(n), 1.0),
                    kernel_names("iqr"))


IQR_120K = 120_000   # scores: 1 ms bins of the Table-1 trace


def phase_times(shapes):
    """Kernel, plain version and a one-call yardstick at the main path's
    shapes, with each kernel's bound."""
    import torch

    from repro_torch.core.reducers import N_BUCKETS
    from repro_torch.kernels.binstats.ops import _ts_bins
    from repro_torch.kernels.histbin.ops import bucketize

    counters = _launch_counters()
    rows = {}

    def record(name, *args, **kwargs):
        rows[name] = time_row(*args, **kwargs)

    seg, vals, n_seg, valid = shapes["binstats_flat"]
    m, n = vals.shape
    out = counters["binstats_flat"](seg, vals, n_seg, valid)
    idx = seg.long().clamp(0, n_seg - 1).expand(m, n)
    record("binstats_flat",
           lambda: counters["binstats_flat"](seg, vals, n_seg, valid),
           lambda: _plain("binstats_flat")(seg, vals, n_seg, valid),
           lambda: torch.zeros(m, n_seg, device=vals.device).scatter_reduce_(
               1, idx, vals, "sum"),
           [out], [seg, vals, valid], 6 * m * n, kernel_names("binstats"))

    seg, vals, n_seg, valid = shapes["histbin_flat"]
    out = counters["histbin_flat"](seg, vals, n_seg, valid)
    fused = ((torch.arange(m, device=vals.device)[:, None] * n_seg
              + seg.long()[None, :]) * N_BUCKETS + bucketize(vals)).reshape(-1)
    record("histbin_flat",
           lambda: counters["histbin_flat"](seg, vals, n_seg, valid),
           lambda: _plain("histbin_flat")(seg, vals, n_seg, valid),
           lambda: torch.bincount(fused, minlength=m * n_seg * N_BUCKETS),
           [out], [seg, vals, valid], 4 * m * n, kernel_names("histbin"))

    # iqr_fences: the main path's float64 call, the same scores in float32
    # (the TPU kernel's contract), the micro-bench's float32 call and a
    # float64 table of 120,000 scores (the large-table path); one kernel a
    # call up to 16,384 keys, at most 16 at 120,000
    (scores, occ), kw = shapes["iqr_fences"]
    (m_scores, m_occ), _ = shapes["iqr_fences/micro"]
    for row, (s_, o_), most in (
            ("iqr_fences", (scores, occ), 1),
            ("iqr_fences/f32", (scores.to(torch.float32), occ), 1),
            ("iqr_fences/micro", (m_scores, m_occ), 1),
            ("iqr_fences/120k", iqr_table(scores.device, IQR_120K, 120),
             16)):
        rows[row] = iqr_row(counters["iqr_fences"], _plain("iqr_fences"),
                            s_, o_, kw)
        per_call = rows[row]["kernels_per_call"]
        if not 1 <= per_call <= most:
            raise AssertionError(f"{row}: {per_call} kernels a call, "
                                 f"expected 1 to {most}")

    # the timestamp forms: binstats at the micro-bench's call (its path),
    # and both at the main path's rows binned by synthetic timestamps;
    # yardsticks as for the flat forms, over the same bins: scatter_reduce_
    # (sums only) and bincount over the fused (metric, bin, bucket) index
    for row, name, key in (("binstats", "binstats", "binstats"),
                           ("binstats/table1", "binstats", "ts"),
                           ("histbin", "histbin", "ts")):
        (ts, vals, valid), kw = shapes[key]
        out = counters[name](ts, vals, valid, **kw)
        v2 = vals.reshape(-1, vals.shape[-1])
        m, n_bins = v2.shape[0], kw["n_bins"]
        bins = _ts_bins(ts, kw["total_ns"], n_bins).long()
        if name == "binstats":
            idx = bins.expand(m, -1)
            library = (lambda idx=idx, v2=v2, m=m, n_bins=n_bins:
                       torch.zeros(m, n_bins, device=v2.device)
                       .scatter_reduce_(1, idx, v2, "sum"))
        else:
            fused = ((torch.arange(m, device=v2.device)[:, None] * n_bins
                      + bins[None, :]) * N_BUCKETS + bucketize(v2)
                     ).reshape(-1)
            library = (lambda fused=fused, size=m * n_bins * N_BUCKETS:
                       torch.bincount(fused, minlength=size))
        record(row, lambda n=name, a=(ts, vals, valid), k=kw:
               counters[n](*a, **k),
               lambda n=name, a=(ts, vals, valid), k=kw: _plain(n)(*a, **k),
               library, [out], [ts, vals, valid],
               (6 if name == "binstats" else 4) * vals.numel(),
               kernel_names(name))

    # rolling_stats: the micro-bench's call and one rank's stall series.
    # Bound: x read and (N, 2) written once (12 N bytes), or about 10
    # float32 operations per value; yardstick: the window sums of x and
    # x^2 as one grouped conv1d with a ones filter (full float32, TF32
    # off), which leaves out the division, the variance and the sqrt.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for row in ("rolling_stats", "rolling_stats/stall"):
            x, window = shapes[row]
            out = counters["rolling_stats"](x, window=window)
            lib = _window_sums(x, window)
            want = _plain("rolling_stats")(x, window=window)
            n_eff = torch.arange(1, x.shape[0] + 1, device=x.device
                                 ).clamp_max(window)
            lib_err = float((lib()[0, 0] / n_eff - want[:, 0]).abs().max())
            log(f"times: {row}: conv1d yardstick's window mean vs plain, "
                f"largest |diff| {lib_err}")
            record(row, lambda x=x, w=window: counters["rolling_stats"](
                x, window=w),
                lambda x=x, w=window: _plain("rolling_stats")(x, window=w),
                lib, [out], [x], 10 * x.numel(), kernel_names("rolling"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # ssd: the serving paths' first-layer calls (mamba2, hymba). Bound:
    # its own inputs read and outputs written once, or 2q^2 N + 2q^2 P +
    # 4qNP FLOP per (head, chunk) on the bfloat16 tensor cores; no single
    # PyTorch call computes the scan, so there is no yardstick.
    for row in ("ssd_fused", "ssd_fused/hymba"):
        c_args, c_kw = shapes[row]
        xs, B = c_args[0], c_args[3]
        b, s, H, P = xs.shape
        N, q = B.shape[3], c_kw["chunk"]
        flops = b * H * (-(-s // q)) * (2 * q * q * N + 2 * q * q * P
                                        + 4 * q * N * P)
        out = counters["ssd_fused"](*c_args, **c_kw)
        record(row, lambda a=c_args, k=c_kw: counters["ssd_fused"](*a, **k),
               lambda a=c_args, k=c_kw: _plain("ssd_fused")(*a, **k), None,
               list(out), list(c_args), flops, kernel_names("ssd"),
               BF16_OPS_PER_S)
        rows[row]["fp32_floor_ms"] = flops / FP32_OPS_PER_S * 1e3

    # flash_attention: hymba's first window-1024 call (29 of the 32 per
    # prefill) and its first global call. Bound: q, k, v read and o
    # written once, or 4 hd FLOP per visible (query, key) pair on the
    # tensor cores of the inputs' type; yardstick: one SDPA call with
    # grouped KV heads (an explicit boolean mask for the window).
    for row in ("flash_attention/window", "flash_attention/global"):
        (q, k, v), c_kw = shapes[row]
        b, s, H, hd = q.shape
        causal, window = c_kw.get("causal", True), c_kw.get("window", 0)
        flops = b * H * _visible_pairs(s, causal, window) * 4 * hd
        out = counters["flash_attention"](q, k, v, **c_kw)
        lib = _sdpa(q, k, v, causal, window)
        plain_out = _plain("flash_attention")(q, k, v, **c_kw)
        lib_err = float((lib().transpose(1, 2).float()
                         - plain_out.float()).abs().max())
        del plain_out
        log(f"times: {row}: SDPA yardstick vs plain, largest |diff| "
            f"{lib_err}")
        record(row, lambda: counters["flash_attention"](q, k, v, **c_kw),
               lambda: _plain("flash_attention")(q, k, v, **c_kw), lib,
               [out], [q, k, v], flops, kernel_names("flashattn"),
               BF16_OPS_PER_S if q.dtype == torch.bfloat16
               else FP32_OPS_PER_S)
        rows[row]["fp32_floor_ms"] = flops / FP32_OPS_PER_S * 1e3
    rows["flash_attention"] = rows["flash_attention/window"]
    return rows


def _window_sums(x, window):
    """One torch.nn.functional.conv1d call giving the trailing-window sums
    of x and x^2 (a timing yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    xx = F.pad(torch.stack([x, x * x])[None], (window - 1, 0))
    ones = torch.ones(2, 1, window, device=x.device)
    return lambda: F.conv1d(xx, ones, groups=2)


def _visible_pairs(s, causal, window):
    """(query, key) pairs the masks leave visible in one (batch, head)."""
    import numpy as np
    i = np.arange(s)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _sdpa(q, k, v, causal, window):
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same inputs (a timing yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(q.shape[1], device=q.device)[None, :]
    mask = (i - j < window) & ((i >= j) if causal else True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


SOURCES = {
    "binstats_flat": ("src/repro_torch/csrc/binstats.cu",
                      "src/repro/kernels/binstats/kernel.py:58"),
    "binstats": ("src/repro_torch/csrc/binstats.cu",
                 "src/repro/kernels/binstats/kernel.py:58"),
    "histbin_flat": ("src/repro_torch/csrc/histbin.cu",
                     "src/repro/kernels/histbin/kernel.py:50"),
    "histbin": ("src/repro_torch/csrc/histbin.cu",
                "src/repro/kernels/histbin/kernel.py:50"),
    "iqr_fences": ("src/repro_torch/csrc/iqr.cu",
                   "src/repro/kernels/iqr/kernel.py:72"),
    "ssd_fused": ("src/repro_torch/csrc/ssd.cu",
                  "src/repro/kernels/ssd/kernel.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn/kernel.py:30"),
    "rolling_stats": ("src/repro_torch/csrc/rolling.cu",
                      "src/repro/kernels/rolling/kernel.py:25"),
}
# the kernels timed at a second call, reported beside the first
ALSO = {"binstats": ("binstats/table1",),
        "iqr_fences": ("iqr_fences/f32", "iqr_fences/micro",
                       "iqr_fences/120k"),
        "ssd_fused": ("ssd_fused/hymba",),
        "flash_attention": ("flash_attention/global",),
        "rolling_stats": ("rolling_stats/stall",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--duration", type=float, default=120.0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    log(card)
    t0 = time.perf_counter()
    ptxas = _ptxas_report(_build)
    built = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    _build.operators()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(nvcc seconds per library: {built})")
    sass = {lib: _sass_counts(_build.lib_path(lib), _build)
            for lib in ("flashattn", "ssd")}
    regs = ptxas()
    log(f"build: SASS instructions {sass}; (registers, spill bytes) {regs}")
    for lib, counts in sass.items():
        if not all(counts.values()):
            raise AssertionError(f"{lib}'s SASS lacks {counts}: its kernel "
                                 "does not run on wgmma with TMA loads")
    wgmma = {k: v for k, v in regs.items() if k.startswith(TENSOR_CORE)}
    if len(wgmma) != 8 or any(sp for _, sp in wgmma.values()):
        raise AssertionError(f"a tensor-core kernel spills: {wgmma}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    edge = phase_kernels(dev)
    log(f"kernels at edge shapes, largest |kernel - plain|: {edge}")
    m_launches, m_errs, m_shapes = phase_micro(dev)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, errs, shapes, stalls = phase_main(args, work)
        log(f"kernels on the main path's inputs, largest |kernel - plain|:"
            f" {errs}")
        s_launches, s_err, shapes["rolling_stats/stall"] = phase_stall(
            dev, stalls)
        del stalls
        phase_delta(args, work)
        d_errs = phase_diff(args, work, card)
        for name, e in d_errs.items():
            errs[name] = max(errs[name], e)
        phase_service(args, work, card)
        phase_stream(args, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # binstats' timestamp form and rolling_stats run on the micro path; the
    # main path's timestamp-form inputs stay as a second timing row
    shapes.update(m_shapes)
    launches["binstats/table1"] = launches["binstats"]
    # the float32 12,000 and the 120,000 tables are on no driven path: no
    # count is taken for them, and the line says null
    launches["iqr_fences/f32"] = None
    launches["iqr_fences/micro"] = m_launches["iqr_fences"]
    launches["iqr_fences/120k"] = None
    launches["binstats"] = m_launches["binstats"]
    launches["rolling_stats"] = m_launches["rolling_stats"]
    launches["rolling_stats/stall"] = s_launches
    for name in ("binstats", "iqr_fences"):
        errs[name] = max(errs[name], m_errs[name])
    errs["rolling_stats"] = max(m_errs["rolling_stats"], s_err)
    serve_launches, serve_errs, calls = phase_serve(args, dev,
                                                    "mamba2-370m", "serve")
    launches["ssd_fused"] = serve_launches["ssd_fused"]
    errs["ssd_fused"] = serve_errs["ssd_fused"]
    shapes["ssd_fused"] = calls["ssd_fused"]
    del calls
    h_launches, h_errs, h_calls = phase_serve(args, dev, "hymba-1.5b",
                                              "serve-hymba")
    launches["flash_attention"] = h_launches["flash_attention"]
    launches["ssd_fused/hymba"] = h_launches["ssd_fused"]
    errs["flash_attention"] = h_errs["flash_attention"]
    errs["ssd_fused"] = max(errs["ssd_fused"], h_errs["ssd_fused"])
    shapes["ssd_fused/hymba"] = h_calls["ssd_fused"]
    for key in ("flash_attention/window", "flash_attention/global"):
        shapes[key] = h_calls[key]
    del h_calls
    times = phase_times(shapes)
    phase_host_trace(shapes)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches[name],
               "max_abs_err": max(errs[name], edge[name]),
               **{k: t[k] for k in keys}}
        if name in ALSO:
            row["also"] = {also: {
                "launches": launches.get(also, launches[name]),
                **{k: times[also][k] for k in keys}} for also in ALSO[name]}
        kernels.append(row)
    for name, t in times.items():
        if name == "flash_attention":
            continue                   # the same row as its window call
        floor = (f", fp32 CUDA-core floor {t['fp32_floor_ms']:.4f}"
                 if "fp32_floor_ms" in t else "")
        n = launches.get(name, launches[name.split('/')[0]])
        path = ("on no driven path" if n is None else
                f"{n} launch(es) of {name.split('/')[0]} on its path")
        log(f"time {name}: {t['ms']:.4f} ms, again {t['ms_again']:.4f} "
            f"(library {t['library_ms']}, again {t['library_ms_again']}; "
            f"device per call under the profiler: own kernels "
            f"{t['device_ms']:.4f}, again {t['device_ms_again']:.4f}, "
            f"other device work {t['other_device_ms']:.4f}, again "
            f"{t['other_device_ms_again']:.4f}, own launches seen "
            f"{t['own_launches']} in 20 calls, other device ops "
            f"{t['other_device_ops']}, own kernels a call "
            f"{t['kernels_per_call']}; plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} by "
            f"{t['bound_by']}: {t['bytes']} bytes {t['bytes_ms']:.4f}, "
            f"{t['ops']:.4g} ops {t['ops_ms']:.4f}{floor}), {path} "
            f"[{card}]")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the tensor-core SSD kernel goes, on one NVIDIA card.

    python3 scripts/ssd_stage_times.py [--calls 20]

Builds ``src/repro_torch/csrc/ssd.cu`` as it is, and copies of it with one
stage of ``ssd_wgmma`` taken out or replaced (each an exact text edit,
checked to apply), with nvcc into ``build/ssd_stages/``, all compiles
started together. Each library then runs in a process of its own, at the
two serving calls' shapes (mamba2-370m: b 8, S 2048, H 32, P 64, N 128;
hymba-1.5b: b 8, S 2176, H 50, P 64, N 16; bfloat16 x, B and C, chunk
128), and is timed by CUDA events over ``--calls`` back-to-back launches,
twice, the libraries in one order and then in the reverse order. The
copies compute wrong results: they exist to be timed beside the kernel.

Variants:
  kernel          the source as it is
  expf_M          M's exponents by expf of cum differences instead of
                  ex2 of the producer's cum log2(e)
  no_lo_products  the three lo products dropped (M x, C h^T, x^T W)
  no_exp_M        M's exponents dropped
  no_W_pass       the pass that forms W over B and C dropped
  no_state_mma    the state product dropped
  no_intra_mma    the intra product M x dropped
  no_S_inter_mma  the scores and inter products dropped

The first line printed is the card's name and power limit as nvidia-smi
gives them; then one line per variant and shape. Needs one CUDA card and
nvcc; exits non-zero without either.
"""

from __future__ import annotations

import ctypes
import sys

import stage_variants

SOURCE = stage_variants.ROOT / "src" / "repro_torch" / "csrc" / "ssd.cu"
OUT = stage_variants.ROOT / "build" / "ssd_stages"
SHAPES = {"mamba2": (8, 2048, 32, 64, 1, 128),
          "hymba": (8, 2176, 50, 64, 1, 16)}
VARIANTS = {
    "kernel": [],
    "expf_M": [("sv.cum2[row0], ci1 = sv.cum2[row1]",
                "sv.cum[row0], ci1 = sv.cum[row1]"),
               ("reinterpret_cast<const float2*>(sv.cum2 + j)",
                "reinterpret_cast<const float2*>(sv.cum + j)"),
               ("s0 * ex2(ci - cj.x)", "s0 * expf(ci - cj.x)"),
               ("s1 * ex2(ci - cj.y)", "s1 * expf(ci - cj.y)")],
    "no_lo_products": [("      mma_rs_n64(yacc, ml[ks], dx);\n", ""),
                       ("for (int part = 0; part < 2; ++part)",
                        "for (int part = 0; part < 1; ++part)")],
    "no_exp_M": [("s0 * ex2(ci - cj.x) * dj.x", "s0 * dj.x"),
                 ("s1 * ex2(ci - cj.y) * dj.y", "s1 * dj.y")],
    "no_W_pass": [("o < G::BC_BYTES;",
                   "o < (a.nc < 0 ? G::BC_BYTES : 0u);")],
    "no_state_mma": [("mma_ss<NS, 1, 1>(hacc,",
                      "if (a.nc < 0) mma_ss<NS, 1, 1>(hacc,")],
    "no_intra_mma": [("mma_rs_n64(yacc, mh[ks], dx);",
                      "if (a.nc < 0) mma_rs_n64(yacc, mh[ks], dx);"),
                     ("mma_rs_n64(yacc, ml[ks], dx);",
                      "if (a.nc < 0) mma_rs_n64(yacc, ml[ks], dx);")],
    "no_S_inter_mma": [("mma_ss<KJ, 0, 0>(sacc,",
                        "if (a.nc < 0) mma_ss<KJ, 0, 0>(sacc,"),
                       ("mma_ss<PT, 0, 0>(",
                        "if (a.nc < 0) mma_ss<PT, 0, 0>(")],
}


def time_variant(name: str, calls: int) -> None:
    """Time one library at both shapes (run in a process of its own)."""
    import numpy as np
    import torch

    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ssd_scan_bf16
    fn.argtypes = [p] * 8 + [i] * 6 + [ctypes.POINTER(ctypes.c_long), p]
    fn.restype = i
    dev = torch.device("cuda")
    for shape_name, (b, s, H, P, G, N) in SHAPES.items():
        rng = np.random.default_rng(0)
        bf = torch.bfloat16

        def t(a, dtype=torch.float32):
            return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
        xs = t(rng.normal(size=(b, s, H, P)), bf)
        dt = t(rng.uniform(0.01, 0.1, (b, s, H)))
        a_log, d = t(rng.uniform(-1, 1, H)), t(rng.normal(size=H))
        B = t(rng.normal(size=(b, s, G, N)), bf)
        C = t(rng.normal(size=(b, s, G, N)), bf)
        y = torch.empty((b, s, H, P), dtype=bf, device=dev)
        state = torch.empty((b, H, P, N), device=dev)
        strides = (ctypes.c_long * 9)(*xs.stride()[:3], *B.stride()[:3],
                                      *C.stride()[:3])
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(xs.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                      B.data_ptr(), C.data_ptr(), d.data_ptr(), y.data_ptr(),
                      state.data_ptr(), b, s, H, P, G, N, strides, stream)
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code}")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"{name} {shape_name} {start.elapsed_time(end) / calls:.4f} ms",
              flush=True)


if __name__ == "__main__":
    sys.exit(stage_variants.main(__file__, __doc__, SOURCE, OUT,
                                 VARIANTS, time_variant, 20))

#!/usr/bin/env python3
"""How the tensor-core attention kernel issues S = Q K^T, timed on one
NVIDIA card.

    python3 scripts/flash_issue_times.py [--calls 20]

Builds ``src/repro_torch/csrc/flashattn.cu`` as it is, and copies of it
with the S product issued another way (each an exact text edit, checked
to apply), with nvcc into ``build/flash_issue/``, all compiles started
together. Each library then runs in a process of its own at four serving
calls' shapes (deepseek-v2-236b's MLA: b 4, S 2048, 128 heads, q and k
192, v 128; nemotron-4-15b: 48 over 8 heads of 128; hymba-1.5b's window
layer: b 8, S 2176, 25 over 5 heads of 64, window 1024; stablelm-3b: 32
heads of 80), bfloat16, causal, is held against the plain version
(within one rounding step) and is timed by CUDA events over ``--calls``
back-to-back launches, twice, the libraries in one order and then in the
reverse order.

Variants:
  kernel          the source as it is: at HD > 128 each descriptor built
                  inside the product's PTX, at HD <= 128 in C++
  cpp_desc        C++ descriptors at every HD, fully unrolled (at HD 192
                  ptxas hoists them and spills)
  ptx_desc        descriptors inside the PTX at every HD
  cpp_unroll4     C++ descriptors, the k-steps unrolled by 4 (no spill;
                  ptxas serialises the products, C7520)

The first line printed is the card's name and power limit as nvidia-smi
gives them; then one line per variant and shape. Needs one CUDA card and
nvcc; exits non-zero without either.
"""

from __future__ import annotations

import ctypes
import sys

import stage_variants

SOURCE = (stage_variants.ROOT / "src" / "repro_torch" / "csrc"
          / "flashattn.cu")
OUT = stage_variants.ROOT / "build" / "flash_issue"
SHAPES = {  # b, s, H, Hkv, hd, hdv, window
    "deepseek": (4, 2048, 128, 128, 192, 128, 0),
    "nemotron": (4, 2048, 48, 8, 128, 128, 0),
    "hymba_window": (8, 2176, 25, 5, 64, 64, 1024),
    "stablelm": (4, 2048, 32, 32, 80, 80, 0),
}
CHOICE = "if constexpr (HD > 128) {"
UNROLL = "#pragma unroll\n        for (int ks = 0; ks < HD / 16;"
VARIANTS = {
    "kernel": [],
    "cpp_desc": [(CHOICE, "if constexpr (false) {")],
    "ptx_desc": [(CHOICE, "if constexpr (true) {")],
    "cpp_unroll4": [(CHOICE, "if constexpr (false) {"),
                    (UNROLL, UNROLL.replace("unroll", "unroll 4"))],
}


def time_variant(name: str, calls: int) -> None:
    """Time one library at every shape (run in a process of its own)."""
    import torch

    sys.path.insert(0, str(stage_variants.ROOT / "src"))
    from repro_torch.kernels.flashattn import flash_attention_plain

    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.flash_attn_bf16
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_long), ctypes.c_float, i, i, p]
    fn.restype = i
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, (b, s, H, Hkv, hd, hdv, window) in SHAPES.items():
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for n, d in ((H, hd), (Hkv, hd), (Hkv, hdv)))
        out = torch.empty(b, s, H, hdv, device=dev, dtype=torch.bfloat16)
        strides = (ctypes.c_long * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, s, H, Hkv, hd, hdv, strides,
                      hd ** -0.5, 1, window, stream)
            if code:
                raise RuntimeError(f"{name} {shape}: CUDA error {code}")
        call()
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        err = (out.double() - want.double()).abs()
        ok = bool((err <= 2e-4 + 2 ** -7 * want.double().abs()).all())
        del want
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
        print(f"{name} {shape}: {start.elapsed_time(end) / calls:.4f} ms "
              f"(max |kernel - plain| {float(err.max())}, within one "
              f"rounding step: {ok})", flush=True)


if __name__ == "__main__":
    sys.exit(stage_variants.main(__file__, __doc__, SOURCE, OUT, VARIANTS,
                                 time_variant, calls=20))

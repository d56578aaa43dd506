"""Online-softmax attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Both take the model's layout (``repro/kernels/flashattn/ops.py``)::

    q (b, s, H, hd), k (b, s, Hkv, hd), v (b, s, Hkv, hdv),
    H a multiple of Hkv, hdv <= hd

and return ``(b, s, H, hdv)`` in q's dtype: v's head dim may be smaller
than the query and key one, as MLA's is (deepseek-v2: hd 192 = 128 nope +
64 rope, hdv 128; ``repro/models/attention.py::chunked_attention`` takes
the same). Query head ``h`` reads KV head ``h // (H // Hkv)``. Key ``j``
is visible to query ``i`` iff ``i >= j`` when ``causal`` and
``i - j < window`` when ``window > 0``; a row that sees no key gives 0.
``scale`` defaults to ``hd ** -0.5``, of the query and key head dim.

:func:`flash_attention` given CPU tensors runs
:func:`flash_attention_plain`; given CUDA tensors it launches a kernel of
``repro_torch/csrc/flashattn.cu`` on q, k and v as they lie, through their
strides, or raises. The kernel follows the dtype: bfloat16 runs the
tensor-core kernel (``flash_attn_bf16``: wgmma products, K/V streamed by
TMA), float32 the CUDA-core kernel (``flash_attn_f32``), each in the
smallest of its instantiations (HD, HDV) = (16, 16), (32, 32), (64, 64),
(128, 128) or (192, 128) that takes (hd, hdv).
``flash_attention.launches`` counts every kernel launch,
``flash_attention.wgmma_launches`` those of the tensor-core kernel and
``flash_attention.instances`` every launch by its (HD, HDV).

Under autograd (grad mode on and an input that requires grad) the call
goes through :class:`_FlashAttention`: its forward is that same dispatch,
and its backward recomputes :func:`flash_attention_plain` from the saved
q, k and v and differentiates it. The reference has no backward kernel:
its training differentiates ``repro/models/attention.py``'s
``chunked_attention``, whose function the plain version computes. This is
the one place where a CUDA tensor reaches the plain version; a backward
kernel is later work (ROADMAP, "Later work"). The plain version is dense:
at hymba's S = 2176 and 25 heads one float32 (H, S, S) tensor takes 473 MB
a sequence, and its backward holds a few of them for one layer at a time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .._autograd import recompute_grads
from .._check import stream_ptr

ALIGN = 8             # elements: hd, hdv and every stride, 16-byte loads


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d (b, s, heads, head_dim)")
    b, s, H, hd = q.shape
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v.shape[3] > hd:
        raise ValueError(f"v's head_dim {v.shape[3]} is above q and k's "
                         f"{hd}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not split over {k.shape[2]} "
                         "KV heads")


def _scale(hd: int, scale: Optional[float]) -> float:
    return hd ** -0.5 if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention`, on any device: the dense
    masked softmax of ``repro/kernels/flashattn/ref.py`` in float32, with
    the KV heads expanded to the query heads."""
    _check_shapes(q, k, v)
    s, H, hd = q.shape[1], q.shape[2], q.shape[3]
    g = H // k.shape[2]
    f32 = torch.float32
    kf = k.to(f32).repeat_interleave(g, dim=2)
    vf = v.to(f32).repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kf) * _scale(hd,
                                                                     scale)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= i >= j
    if window > 0:
        mask &= (i - j) < window
    # out of place throughout: autograd differentiates this function
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    del logits
    p = p.masked_fill(~mask, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-20)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal / sliding-window attention with grouped KV heads (the TPU
    kernel's contract, ``repro/kernels/flashattn/ops.py::flash_attention``,
    with the KV heads grouped instead of expanded).

    The kernel takes bfloat16 or float32 q, k and v of one dtype, head
    dims hd and hdv that are multiples of 8 and fit an instantiation
    (hd up to 128, or up to 192 with hdv up to 128), a contiguous last
    dimension, other strides that are multiples of 8 and 16-byte aligned
    data, and in bfloat16 a positive scale; it raises on anything else.
    With grad mode on and any of q, k, v requiring grad the call goes
    through :class:`_FlashAttention` (the module docstring says how)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _forward(q, k, v, causal, window, scale):
    """:func:`flash_attention`'s dispatch: the plain version for CPU
    tensors, a kernel launch for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_shapes(q, k, v)
    b, s, H, hd = q.shape
    Hkv, hdv = k.shape[2], v.shape[3]
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q/k/v dtype {q.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernel takes one of bfloat16 or float32")
    lib = _lib()
    inst = lib.flash_attn_instance(hd, hdv)
    if hd % ALIGN or hdv % ALIGN or not inst:
        raise ValueError(f"head_dim {hd} (v {hdv}): the kernel takes "
                         f"multiples of {ALIGN} up to 128, or q and k's up "
                         "to 192 with v's up to 128")
    if s < 1 or b < 1:
        raise ValueError("flash_attention: empty batch or sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.stride(3) != 1 or any(st % ALIGN for st in t.stride()[:3]):
            raise ValueError(f"{name}: strides {t.stride()}: the kernel "
                             f"takes a contiguous head_dim and other strides "
                             f"that are multiples of {ALIGN}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data not 16-byte aligned")
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores and not _scale(hd, scale) > 0:
        raise ValueError(f"scale {scale}: the bfloat16 kernel takes a "
                         "positive scale")
    fn = lib.flash_attn_bf16 if tensor_cores else lib.flash_attn_f32
    out = torch.empty((b, s, H, hdv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_long * 9)(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, s, H, Hkv, hd, hdv, strides, _scale(hd, scale),
                  int(causal), int(window), stream_ptr(q.device))
    flash_attention.launches += 1
    flash_attention.wgmma_launches += tensor_cores
    key = (inst >> 16, inst & 0xFFFF)
    flash_attention.instances[key] = flash_attention.instances.get(key, 0) + 1
    _build.check(code, "flash_attention")
    return out


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.instances = {}


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the kernel (or, on the CPU,
    the plain version) forward; backward recomputes
    :func:`flash_attention_plain` from the saved q, k and v and returns
    its gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.opts = (causal, window, scale)
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g_out):
        causal, window, scale = ctx.opts
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_attention.plain_recompute"):
            out = flash_attention_plain(*inputs, causal=causal,
                                        window=window, scale=scale)
            return (*recompute_grads([out], [g_out], inputs), None, None,
                    None)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flashattn")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.flash_attn_bf16, lib.flash_attn_f32):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i,
                           ctypes.POINTER(ctypes.c_long), ctypes.c_float, i,
                           i, p]
            fn.restype = i
        lib.flash_attn_instance.argtypes = [i, i]
        lib.flash_attn_instance.restype = i
        lib._typed = True
    return lib

"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Both take the model's layout (``repro/kernels/ssd/ops.py::ssd_fused``):

    xs (b, s, H, P), dt (b, s, H), A_log (H,), B and C (b, s, G, N), D (H,)

and return ``(y (b, s, H, P) in xs.dtype, state (b, H, P, N) float32)``,
with ``y = SSD(dt·x) + D·x``. Head ``h`` reads group ``h // (H // G)``.
Everything inside the scan is float32: dt, A, x̄ = dt·x, the decay
exponents and the state.

:func:`ssd_fused` given CPU tensors runs :func:`ssd_fused_plain`; given
CUDA tensors it launches one of the two kernels of
``repro_torch/csrc/ssd.cu`` or raises (see :func:`ssd_fused` for which).
``ssd_fused.launches`` counts kernel launches and
``ssd_fused.wgmma_launches`` those of the tensor-core kernel.

Under autograd (grad mode on and an input that requires grad) the call
goes through :class:`_SSDFused`: its forward is that same dispatch, and
its backward recomputes :func:`ssd_fused_plain` from the saved inputs and
differentiates it. The reference has no backward kernel: its training
differentiates the XLA scan that :func:`ssd_fused_plain` copies
(``repro/models/ssm.py::ssd_scan``). This is the one place where a CUDA
tensor reaches the plain version; a backward kernel is later work
(ROADMAP, "Later work").
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .._autograd import recompute_grads
from .._check import check_tensor, stream_ptr

P_TILE = 64       # the CUDA-core kernel's limits (csrc/ssd.cu)
MAX_CHUNK = 128
MAX_STATE = 128
TC_CHUNK = 128    # the tensor-core kernel's chunk


def _check_shapes(xs, dt, A_log, B, C, D) -> None:
    if xs.dim() != 4 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("xs, B and C must be 4-d (b, s, heads|groups, dim)")
    b, s, H, _ = xs.shape
    G = B.shape[2]
    if tuple(dt.shape) != (b, s, H):
        raise ValueError(f"dt {tuple(dt.shape)}, expected {(b, s, H)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} do not "
                         f"match xs {tuple(xs.shape)}")
    if tuple(A_log.shape) != (H,) or tuple(D.shape) != (H,):
        raise ValueError(f"A_log and D must be ({H},)")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")


def ssd_fused_plain(xs: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssd_fused`, on any device: the chunked SSD
    of ``repro/models/ssm.py::ssd_scan``, a loop over chunks that carries
    the (b, H, P, N) state."""
    _check_shapes(xs, dt, A_log, B, C, D)
    b, s, H, Pd = xs.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    f32 = torch.float32
    x = F.pad(xs.to(f32), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(f32), (0, 0, 0, pad))        # dt = 0: identity step
    Bf = F.pad(B.to(f32), (0, 0, 0, 0, 0, pad))
    Cf = F.pad(C.to(f32), (0, 0, 0, 0, 0, pad))
    A = -torch.exp(A_log.to(f32))                   # (H,) < 0
    Df = D.to(f32)[None, None, :, None]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                   device=xs.device))[None, :, None, None, :]
    h = torch.zeros(b, G, hg, Pd, N, dtype=f32, device=xs.device)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xck, dtk, Bk, Ck = x[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtk * A, dim=1)           # (b, q, H) <= 0
        last = cum[:, -1, :]                         # (b, H)
        xg = (dtk[..., None] * xck).reshape(b, q, G, hg, Pd)
        cumg = cum.reshape(b, q, G, hg)
        scores = torch.einsum("bign,bjgn->bgij", Ck, Bk)
        li = cumg[:, :, :, :, None] - cumg.permute(0, 2, 3, 1)[:, None]
        # exp only of the masked exponents: above the diagonal li > 0
        L = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)), 0.0)
        y_intra = torch.einsum("bgij,bighj,bjghp->bighp", scores, L, xg)
        y_inter = torch.einsum("bign,bghpn,bigh->bighp", Ck, h,
                               torch.exp(cumg))
        decay = torch.exp(last.reshape(b, 1, G, hg) - cumg)
        upd = torch.einsum("bjgn,bjghp,bjgh->bghpn", Bk, xg, decay)
        h = torch.exp(last).reshape(b, G, hg, 1, 1) * h + upd
        y = (y_intra + y_inter).reshape(b, q, H, Pd) + Df * xck
        ys.append(y.to(xs.dtype))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h.reshape(b, H, Pd, N)


def ssd_fused(xs: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
              chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk scan plus ``D·x`` (the TPU kernel's contract,
    ``repro/kernels/ssd/ops.py::ssd_fused``).

    With grad mode on and any input requiring grad the call goes through
    :class:`_SSDFused` (the module docstring says how its backward works);
    otherwise it is the dispatch below and nothing else.

    On CUDA tensors the kernel is chosen by a fixed rule, with no fallback
    on failure:

    * bfloat16 ``xs``, ``B`` and ``C`` with ``chunk == 128``, P a multiple
      of 16 up to 64 and N a multiple of 16 up to 128 (the serving path's
      calls) run the tensor-core kernel ``ssd_wgmma``. It reads the model
      layout in place (``xs``, ``B`` and ``C`` through their strides, which
      must be multiples of 8 elements with a contiguous last dimension),
      computes ``dt·(-exp(A_log))`` and its chunk cumsum itself, masks the
      ragged last chunk with ``dt = 0`` and writes ``y`` in bfloat16 and
      the state in float32: one launch, no copies. Counted in
      ``ssd_fused.wgmma_launches``.
    * Everything else (float32 inputs, other shapes) runs the CUDA-core
      kernel ``ssd_scan_kernel`` on head-major float32 copies of
      ``x̄ = dt·x`` and ``dtA``, the sequence padded to a multiple of
      ``chunk``; B and C reach it in bfloat16 or float32. It takes
      chunk <= 128, N <= 128 and P at most 64 or a multiple of 64, and
      raises on anything else."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, dt, A_log, B, C, D)):
        return _SSDFused.apply(xs, dt, A_log, B, C, D, chunk)
    return _forward(xs, dt, A_log, B, C, D, chunk)


def _forward(xs, dt, A_log, B, C, D, chunk):
    """:func:`ssd_fused`'s dispatch: the plain version for CPU tensors, a
    kernel launch for CUDA tensors."""
    if xs.device.type == "cpu":
        return ssd_fused_plain(xs, dt, A_log, B, C, D, chunk=chunk)
    if xs.device.type != "cuda":
        raise ValueError(f"ssd_fused: unsupported device {xs.device}")
    _check_shapes(xs, dt, A_log, B, C, D)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 to {MAX_CHUNK}")
    if B.dtype not in (torch.bfloat16, torch.float32) or C.dtype != B.dtype:
        raise TypeError(f"B/C dtype {B.dtype}/{C.dtype}: the kernel takes "
                        "bfloat16 or float32")
    b, s, H, Pd = xs.shape
    G, N = B.shape[2], B.shape[3]
    if s < 1:
        raise ValueError("ssd_fused: empty sequence")
    if N > MAX_STATE:
        raise ValueError(f"d_state {N}: the kernel takes at most {MAX_STATE}")
    if Pd > P_TILE and Pd % P_TILE:
        raise ValueError(f"head_dim {Pd}: the kernel takes P <= {P_TILE} or "
                         f"a multiple of {P_TILE}")
    if _tensor_core_call(xs, B, C, chunk):
        return _ssd_wgmma(xs, dt, A_log, B, C, D)
    dev = xs.device
    f32 = torch.float32
    dtf = dt.to(f32)
    dta = dtf * -torch.exp(A_log.to(f32))[None, None, :]           # (b,s,H)
    xbar = dtf[..., None] * xs.to(f32)                             # (b,s,H,P)
    pad = (-s) % chunk
    # head-major (BH, S, P) / (BH, S) / (BG, S, N), padded with zeros
    xbar_h = F.pad(xbar.permute(0, 2, 1, 3), (0, 0, 0, pad))
    dta_h = F.pad(dta.permute(0, 2, 1), (0, pad))
    B_h = F.pad(B.permute(0, 2, 1, 3), (0, 0, 0, pad))
    C_h = F.pad(C.permute(0, 2, 1, 3), (0, 0, 0, pad))
    sp = s + pad
    xbar_h = xbar_h.reshape(b * H, sp, Pd).contiguous()
    dta_h = dta_h.reshape(b * H, sp).contiguous()
    B_h = B_h.reshape(b * G, sp, N).contiguous()
    C_h = C_h.reshape(b * G, sp, N).contiguous()
    for t, name, dtype, nd in ((xbar_h, "xbar", f32, 3),
                               (dta_h, "dta", f32, 2),
                               (B_h, "B", B.dtype, 3), (C_h, "C", B.dtype, 3)):
        check_tensor(t, name, dtype, nd, dev)
    lib = _lib()
    y_h = torch.empty((b * H, sp, Pd), dtype=f32, device=dev)
    state = torch.empty((b * H, Pd, N), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = lib.ssd_scan(xbar_h.data_ptr(), dta_h.data_ptr(),
                            B_h.data_ptr(), C_h.data_ptr(),
                            int(B.dtype == torch.bfloat16), y_h.data_ptr(),
                            state.data_ptr(), b * H, sp, Pd, N, chunk,
                            H // G, stream_ptr(dev))
    ssd_fused.launches += 1
    _build.check(code, "ssd_fused")
    y = y_h[:, :s].reshape(b, H, s, Pd).permute(0, 2, 1, 3)
    y = y + D.to(f32)[None, None, :, None] * xs.to(f32)
    return y.to(xs.dtype), state.reshape(b, H, Pd, N)


ssd_fused.launches = 0
ssd_fused.wgmma_launches = 0


class _SSDFused(torch.autograd.Function):
    """:func:`ssd_fused` under autograd: the kernel (or, on the CPU, the
    plain version) forward; backward recomputes :func:`ssd_fused_plain`
    from the saved inputs and returns its gradients. Gradients flow to
    ``xs``, ``dt``, ``A_log``, ``B``, ``C`` and ``D``; the incoming
    gradient of the final state may be None."""

    @staticmethod
    def forward(ctx, xs, dt, A_log, B, C, D, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)     # an unused state stays None
        ctx.save_for_backward(xs, dt, A_log, B, C, D)
        return _forward(xs, dt, A_log, B, C, D, chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:6])]
        with torch.enable_grad(), \
                torch.profiler.record_function("ssd_fused.plain_recompute"):
            outs = ssd_fused_plain(*inputs, chunk=ctx.chunk)
            return (*recompute_grads(outs, (g_y, g_state), inputs), None)


def _tensor_core_call(xs, B, C, chunk) -> bool:
    """Whether :func:`ssd_fused` runs the tensor-core kernel (its docstring
    gives the rule)."""
    bf = torch.bfloat16
    Pd, N = xs.shape[3], B.shape[3]
    return (xs.dtype == bf and B.dtype == bf and C.dtype == bf
            and chunk == TC_CHUNK and Pd % 16 == 0 and 16 <= Pd <= P_TILE
            and N % 16 == 0 and 16 <= N <= MAX_STATE)


def _ssd_wgmma(xs, dt, A_log, B, C, D):
    """One launch of ``ssd_wgmma`` on the model-layout tensors."""
    b, s, H, Pd = xs.shape
    G, N = B.shape[2], B.shape[3]
    dev = xs.device
    f32 = torch.float32
    for t, name in ((xs, "xs"), (B, "B"), (C, "C")):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name}: strides {t.stride()}: the tensor-core "
                             "kernel takes a contiguous last dimension, "
                             "other strides multiples of 8 and a 16-byte "
                             "aligned start")
    dtf = dt.to(f32).contiguous()
    a_log = A_log.to(f32).contiguous()
    d = D.to(f32).contiguous()
    for t, name in ((dtf, "dt"), (a_log, "A_log"), (d, "D")):
        check_tensor(t, name, f32, t.dim(), dev)
    y = torch.empty((b, s, H, Pd), dtype=xs.dtype, device=dev)
    state = torch.empty((b, H, Pd, N), dtype=f32, device=dev)
    strides = (ctypes.c_long * 9)(*xs.stride()[:3], *B.stride()[:3],
                                  *C.stride()[:3])
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.ssd_scan_bf16(xs.data_ptr(), dtf.data_ptr(),
                                 a_log.data_ptr(), B.data_ptr(),
                                 C.data_ptr(), d.data_ptr(), y.data_ptr(),
                                 state.data_ptr(), b, s, H, Pd, G, N,
                                 strides, stream_ptr(dev))
    ssd_fused.launches += 1
    ssd_fused.wgmma_launches += 1
    _build.check(code, "ssd_fused")
    return y, state


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    if not getattr(lib, "_typed", False):
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.ssd_scan.argtypes = [p, p, p, p, i, p, p, l, i, i, i, i, i, p]
        lib.ssd_scan.restype = i
        lib.ssd_scan_bf16.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, ctypes.POINTER(l), p]
        lib.ssd_scan_bf16.restype = i
        lib._typed = True
    return lib

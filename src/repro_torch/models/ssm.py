"""Mamba2 SSD mixer (state-space duality, arXiv:2405.21060) and its decode
state, after ``repro/models/ssm.py``.

Prefill runs the chunked SSD scan through
:func:`repro_torch.kernels.ssd.ssd_fused`: on a CUDA tensor that is the
hand-written kernel, on a CPU tensor its plain version. Decode is the O(1)
recurrence ``h ← a·h + dt·x⊗B, y = C·h + D·x`` plus a rolling window for
the causal depthwise conv.

Precision follows the reference: dt, A, x̄ and the state are float32; y
and the projections are in the model dtype. Public layouts are the
reference's: ``(B, S, H, P)``, ``(B, S, G, N)``, state ``(B, H, P, N)``.
With a tensor-parallel context (:mod:`.shardrules`, :mod:`.tp`) the
parameters are the rank's: ``in_z``, ``in_x``, ``in_dt``, ``A_log``,
``D``, ``dt_bias``, the norm's scale and ``out_proj``'s rows hold its
H/T heads, every conv its block of channels, and ``in_b`` / ``in_c`` are
whole. A rank convolves its channels of B and C and gathers the rest,
scans its heads, normalises over the whole ``d_inner`` (one float32
ordered sum of squares) and adds ``out_proj``'s partials with one
ordered sum. Its decode cache holds its heads' state and ``conv_x``
channels, and the whole ``conv_b`` / ``conv_c`` tails.

Where T does not divide the SSM heads (hymba's 50 at T = 4), the rules
keep ``in_dt``, ``A_log``, ``D``, ``dt_bias`` and the ``state`` cache
whole but still cut ``in_z``, ``in_x``, ``conv_x``, the norm's scale and
``out_proj``'s rows into blocks of ``d_inner`` / T channels, which do
not fall on head boundaries. Then every rank gathers the convolved x
channels whole, scans every head (the same launch as at one rank),
keeps its block of the channels of ``y`` and goes on as above; its
decode recurrence runs on the whole state. In training the whole scan's
gradient is then summed over the ranks once, where ``y`` enters the
rank's block; ``in_dt`` reads ``x`` as it is and the gathered B and C
feed the scan without an entry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_fused
from . import tp
from .layers import dense_init
from .shardrules import ParallelCtx, tp_size


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1           # G
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


# --- init ---------------------------------------------------------------------

def ssm_init(cfg: SSMConfig, *, generator: torch.Generator,
             device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict:
    """Parameters of one mixer: the drawn matrices in ``dtype``, the
    vectors in float32."""
    d, di, gn, h, w = (cfg.d_model, cfg.d_inner,
                       cfg.n_groups * cfg.d_state, cfg.n_heads,
                       cfg.conv_width)
    f32 = torch.float32
    kw = {"generator": generator, "device": device, "dtype": dtype}
    # dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand(h, generator=generator, device=device)
    dt = torch.exp(u * (np.log(cfg.dt_max) - np.log(cfg.dt_min))
                   + np.log(cfg.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    return {
        "in_z": dense_init((d, di), **kw),
        "in_x": dense_init((d, di), **kw),
        "in_b": dense_init((d, gn), **kw),
        "in_c": dense_init((d, gn), **kw),
        "in_dt": dense_init((d, h), **kw),
        "conv_x": {"w": dense_init((w, di), fan_in=w, **kw),
                   "b": torch.zeros(di, dtype=f32, device=device)},
        "conv_b": {"w": dense_init((w, gn), fan_in=w, **kw),
                   "b": torch.zeros(gn, dtype=f32, device=device)},
        "conv_c": {"w": dense_init((w, gn), fan_in=w, **kw),
                   "b": torch.zeros(gn, dtype=f32, device=device)},
        "A_log": torch.log(torch.arange(1, h + 1, dtype=f32, device=device)),
        "D": torch.ones(h, dtype=f32, device=device),
        "dt_bias": dt_bias.to(f32),
        "ssm_norm": {"scale": torch.ones(di, dtype=f32, device=device)},
        "out_proj": dense_init((di, d), fan_in=di, **kw),
    }


# --- causal depthwise conv ------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (width, C) depthwise; left-padded causal + silu.

    ``width`` shifted multiply-adds in float32, rounded once to x's dtype:
    a float32 cuDNN convolution would run in TF32 by default, and the
    window is only a few taps wide."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    wf = w.to(x.dtype).float()
    out = xp[:, :s] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + s] * wf[k]
    return F.silu(out + b.to(x.dtype).float()).to(x.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          ctx: Optional[ParallelCtx], local: bool = True) -> torch.Tensor:
    """:func:`_causal_conv` of the channels ``w`` holds: where ``x`` is
    whole and ``w`` a rank's block, the rank's block of channels, then
    the ranks' blocks gathered (exact: each channel is its own conv) and,
    where the scan runs on the rank's heads (``local``), entered
    (``tp.enter``); a scan of every head takes the whole gradient."""
    if w.shape[1] == x.shape[2]:
        return _causal_conv(x, w, b)
    x = tp.local_block(x, w.shape[1], ctx, dim=2)
    out = tp.gather_cat(_causal_conv(x, w, b), -1, ctx)
    return tp.enter(out, ctx) if local else out


def _conv_step(state: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, ctx: Optional[ParallelCtx] = None,
               ) -> torch.Tensor:
    """Decode: state (B, width-1, C), x_new (B, 1, C) -> out (B, 1, C).
    The window in ``state`` moves on by one token in place. Where the
    state is whole and ``w`` a rank's block of channels, as :func:`_conv`.
    """
    window = torch.cat([state, x_new.to(state.dtype)], dim=1)
    state.copy_(window[:, 1:])
    whole = w.shape[1] == window.shape[2]
    window = tp.local_block(window, w.shape[1], ctx, dim=2)
    dt_ = x_new.dtype
    out = (window.to(dt_).float() * w.to(dt_).float()).sum(1)
    out = F.silu(out + b.to(dt_).float()).to(dt_)[:, None, :]
    return out if whole else tp.gather_cat(out, -1, ctx)


def _scanned(xc: torch.Tensor, heads: int, cfg: SSMConfig,
             ctx: Optional[ParallelCtx]) -> torch.Tensor:
    """The convolved x channels of the ``heads`` the rank scans: ``xc``
    itself, or where the rank scans every head (T does not divide them,
    and the rules keep ``in_dt`` whole) but holds a block of the
    channels, the ranks' blocks gathered whole (exact)."""
    if xc.shape[-1] == heads * cfg.head_dim:
        return xc
    return tp.gather_cat(xc, -1, ctx, name="conv")


# --- block forward / decode -------------------------------------------------------

def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-6, ctx: Optional[ParallelCtx] = None,
                ) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` over the whole ``d_inner``: at T > 1
    ``y`` and ``z`` hold a rank's channels, and the sum of squares is a
    float32 ordered sum over the ranks, entered (``tp.enter``) for the
    rank's channels."""
    gf = (y * F.silu(z)).float()
    t = tp_size(ctx)
    if t == 1:
        var = (gf * gf).mean(-1, keepdim=True)
    else:
        var = tp.enter(tp.ordered_sum((gf * gf).sum(-1, keepdim=True),
                                      ctx), ctx) / (gf.shape[-1] * t)
    return (gf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _projections(params, x: torch.Tensor, cfg: SSMConfig,
                 ctx: Optional[ParallelCtx] = None):
    """z, x, B, C and dt's projections: ``in_b`` and ``in_c`` are whole
    and read ``x`` as it is, and so does ``in_dt`` where the rules keep
    it whole (T does not divide the heads: every rank scans them all);
    the others hold the rank's channels or heads and read it entered
    (``tp.enter``)."""
    xe = tp.enter(x, ctx)
    xd = xe if params["in_dt"].shape[1] < cfg.n_heads else x
    return (xe @ params["in_z"], xe @ params["in_x"], x @ params["in_b"],
            x @ params["in_c"], xd @ params["in_dt"])


def ssm_forward(params, x: torch.Tensor, cfg: SSMConfig, cache: bool = True,
                ctx: Optional[ParallelCtx] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Training / prefill forward. x: (B, S, D). Returns (out, decode
    cache entries), the entries None when ``cache`` is False (training
    keeps no decode cache). At T > 1 the scan runs on the rank's heads,
    or on every head where T does not divide them: then its inputs are
    whole on every rank and its gradient is summed once, where ``y``
    enters the rank's block of channels (``tp.local_block``)."""
    tp.check_ssm(cfg, ctx)
    bsz, s, _ = x.shape
    local = params["A_log"].shape[0] < cfg.n_heads
    z, xr, Br, Cr, dt_raw = _projections(params, x, cfg, ctx)
    xc = _conv(xr, params["conv_x"]["w"], params["conv_x"]["b"], ctx)
    Bc = _conv(Br, params["conv_b"]["w"], params["conv_b"]["b"], ctx, local)
    Cc = _conv(Cr, params["conv_c"]["w"], params["conv_c"]["b"], ctx, local)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])        # (B, S, H)
    xc = _scanned(xc, dt.shape[-1], cfg, ctx)
    xs = xc.reshape(bsz, s, dt.shape[-1], cfg.head_dim)
    B3 = Bc.reshape(bsz, s, cfg.n_groups, cfg.d_state)
    C3 = Cc.reshape(bsz, s, cfg.n_groups, cfg.d_state)
    y, h_fin = ssd_fused(xs, dt, params["A_log"], B3, C3, params["D"],
                         chunk=cfg.chunk)
    y = tp.local_block(y.reshape(bsz, s, -1), z.shape[-1], ctx, dim=-1)
    y = _gated_norm(params["ssm_norm"]["scale"], y, z, ctx=ctx)
    out = tp.sum_matmul(y, params["out_proj"], ctx)
    if not cache:
        return out, None

    # decode cache: conv tails (pre-conv inputs) + final SSM state; the
    # tails are copies, so the full projections are freed
    w = cfg.conv_width

    def tail(u):
        t = u[:, -(w - 1):, :]
        return F.pad(t, (0, 0, (w - 1) - t.shape[1], 0)).clone()

    cache = {"conv_x": tail(xr), "conv_b": tail(Br), "conv_c": tail(Cr),
             "state": h_fin}
    return out, cache


def ssm_decode(params, x: torch.Tensor, cache: Dict, cfg: SSMConfig,
               ctx: Optional[ParallelCtx] = None,
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B, 1, D); cache from ssm_forward/init (at
    T > 1 the rank's: its heads' state and ``conv_x`` channels).

    The cache is updated in place and returned (the reference's serving
    loop donates it to the jitted step for the same effect)."""
    tp.check_ssm(cfg, ctx)
    bsz = x.shape[0]
    z, xr, Br, Cr, dt_raw = _projections(params, x, cfg, ctx)
    xc = _conv_step(cache["conv_x"], xr, params["conv_x"]["w"],
                    params["conv_x"]["b"], ctx)
    Bc = _conv_step(cache["conv_b"], Br, params["conv_b"]["w"],
                    params["conv_b"]["b"], ctx)
    Cc = _conv_step(cache["conv_c"], Cr, params["conv_c"]["w"],
                    params["conv_c"]["b"], ctx)

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])    # (B, H)
    xc = _scanned(xc, dt.shape[-1], cfg, ctx)
    a = torch.exp(dt * -torch.exp(params["A_log"].float()))      # (B, H)
    H, Pd, G, N = dt.shape[-1], cfg.head_dim, cfg.n_groups, cfg.d_state
    hg = H // G
    x1 = xc[:, 0].float().reshape(bsz, H, Pd)
    Bh = Bc[:, 0].float().reshape(bsz, G, N).repeat_interleave(hg, dim=1)
    Ch = Cc[:, 0].float().reshape(bsz, G, N).repeat_interleave(hg, dim=1)
    state = cache["state"]                                       # (B,H,P,N)
    state.mul_(a[..., None, None]).add_(
        (dt[..., None] * x1)[..., None] * Bh[:, :, None, :])
    y = (state * Ch[:, :, None, :]).sum(-1) + params["D"][None, :, None] * x1
    y = y.reshape(bsz, 1, H * Pd).to(x.dtype)
    y = tp.local_block(y, z.shape[-1], ctx, dim=-1)
    y = _gated_norm(params["ssm_norm"]["scale"], y, z, ctx=ctx)
    return tp.sum_matmul(y, params["out_proj"], ctx), cache


def ssm_init_cache(cfg: SSMConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Dict:
    w, di, gn = cfg.conv_width, cfg.d_inner, cfg.n_groups * cfg.d_state
    return {
        "conv_x": torch.zeros(batch, w - 1, di, dtype=dtype, device=device),
        "conv_b": torch.zeros(batch, w - 1, gn, dtype=dtype, device=device),
        "conv_c": torch.zeros(batch, w - 1, gn, dtype=dtype, device=device),
        "state": torch.zeros(batch, cfg.n_heads, cfg.head_dim, cfg.d_state,
                             dtype=torch.float32, device=device),
    }

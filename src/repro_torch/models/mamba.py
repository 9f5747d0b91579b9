"""Mamba (S6) selective-state-space mixer, jamba's non-attention layers;
port of ``repro.models.mamba``.

Recurrence (per channel c, state n):
    h_t = exp(-dt_t * A) h_{t-1} + dt_t * B_t * x_t ;   y_t = C_t . h_t + D x_t

Prefill runs the chunked scan (:func:`ssm_scan`): the chunks in order,
carrying the (B, d_inner, d_state) state, with a log-depth associative
scan inside each chunk (:func:`associative_scan`, the recursion of
``jax.lax.associative_scan``, so both packages take the same products in
the same order).  The decay and drive tensors are formed a chunk at a time.
A single-token forward with a cache takes the O(1) step (:func:`ssm_step`).
The in, x and out projections are ``PimLinear``s; the conv and the scan are
plain tensor code, as they are plain ``jnp`` in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import PimContext, PimLinear


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


class MambaMixer(nn.Module):
    """The reference's leaves: the three projections, ``conv_w`` (dc, di)
    and ``dt_proj`` (dt_rank, di) in the parameter dtype, ``dt_bias``
    (di,), ``a_log`` (di, ds) and ``d`` (di,) in f32."""

    def __init__(self, cfg: ModelConfig, prefix: str, dtype, device=None):
        super().__init__()
        di, ds, dc, r = d_inner(cfg), cfg.ssm_d_state, cfg.ssm_d_conv, \
            dt_rank(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(dtype=dtype, device=device)

        def param(*shape, **dt):
            return nn.Parameter(torch.empty(*shape, **dt),
                                requires_grad=False)

        self.in_proj = PimLinear(cfg.d_model, 2 * di,
                                 name=f"{prefix}/in_proj", **kw)
        self.conv_w = param(dc, di, **kw)
        self.x_proj = PimLinear(di, r + 2 * ds, name=f"{prefix}/x_proj",
                                **kw)
        self.dt_proj = param(r, di, **kw)
        self.dt_bias = param(di, **f32)
        self.a_log = param(di, ds, **f32)
        self.d = param(di, **f32)
        self.out_proj = PimLinear(di, cfg.d_model, name=f"{prefix}/out_proj",
                                  **kw)

    def forward(self, x, ctx: PimContext, cache: Optional[dict] = None):
        return apply_mamba(self, x, ctx, cache=cache)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, which rounds otherwise than
    ``torch.nn.functional.softplus`` (that one switches to ``x`` above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B,S,di); w: (dc,di) in x's dtype; state:
    (B,dc-1,di).  The taps add in order from 0, each product and sum
    rounded in the dtype of the state joined to x (``torch.cat`` promotes
    as ``jnp.concatenate`` does), as the reference's Python ``sum``.
    Returns (y, the last dc-1 rows as the new state)."""
    dc, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = 0
    for i in range(dc):
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, -(dc - 1):]


def ssm_coeffs(p: MambaMixer, proj):
    """``x_proj``'s output (B,S,dt_rank+2ds) -> (delta (B,S,di) f32, B_t
    (B,S,ds) f32, C_t (B,S,ds) f32)."""
    r, ds = p.dt_proj.shape[0], p.a_log.shape[1]
    dt_r, b_, c_ = torch.split(proj, [r, ds, ds], dim=-1)
    delta = softplus(dt_r.float() @ p.dt_proj.float() + p.dt_bias)
    return delta, b_.float(), c_.float()


def decay_drive(delta, xc, b_, a_neg):
    """a = exp(-delta A), bx = delta x B: (..., di, ds) each."""
    a = torch.exp(-delta[..., None] * a_neg)
    bx = (delta * xc.float())[..., None] * b_[..., None, :]
    return a, bx


def associative_scan(a, b):
    """The prefix of ``comb((al, bl), (ar, br)) = (al ar, ar bl + br)``
    over dim 1, by the recursion of ``jax.lax.associative_scan``: combine
    pairs at stride 2, scan the reduced sequence, fix up the even
    elements, interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def comb(al, bl, ar, br):
        return al * ar, ar * bl + br
    ra, rb = comb(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = comb(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = comb(oa, ob, a[:, 2::2], b[:, 2::2])
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    for out, first, even, odd in ((out_a, a, ea, oa), (out_b, b, eb, ob)):
        out[:, 0] = first[:, 0]
        out[:, 2::2] = even
        out[:, 1::2] = odd
    return out_a, out_b


def chunk_scan(a, bx, h0):
    """One chunk.  a, bx: (B,C,di,ds); h0: (B,di,ds).  Returns (h at every
    position (B,C,di,ds), the last h)."""
    a_s, b_s = associative_scan(a, bx)
    h = a_s * h0[:, None] + b_s
    return h, h[:, -1]


def ssm_scan(delta, xc, b_, c_, a_neg, h0, chunk: int):
    """The chunked selective scan.  delta/xc: (B,S,di), b_/c_: (B,S,ds),
    S a multiple of ``chunk``; h0: (B,di,ds).  Returns (y (B,S,di) f32,
    the last h)."""
    ys, h = [], h0
    for c0 in range(0, delta.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        a, bx = decay_drive(delta[:, sl], xc[:, sl], b_[:, sl], a_neg)
        hs, h = chunk_scan(a, bx, h)
        ys.append(torch.einsum("bcds,bcs->bcd", hs, c_[:, sl]))
    return torch.cat(ys, dim=1), h


def ssm_step(delta, xc, b_, c_, a_neg, h0):
    """The recurrence for one token.  delta/xc: (B,di); b_/c_: (B,ds);
    h0: (B,di,ds).  Returns (y (B,1,di), h)."""
    a, bx = decay_drive(delta, xc, b_, a_neg)
    h = a * h0 + bx
    return torch.einsum("bds,bs->bd", h, c_)[:, None], h


def apply_mamba(p: MambaMixer, x, ctx: PimContext, *,
                cache: Optional[dict] = None):
    """x: (B,S,D).  cache: {'h': (B,di,ds) f32, 'conv': (B,dc-1,di)}.
    Returns (out, new_cache or None).  A single token with a cache takes
    the step (whatever the mode); otherwise S is padded on the right to a
    multiple of the chunk with delta = 0 (a = 1, bx = 0: the state passes
    through the pad unchanged) and the pad's outputs are dropped."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    di, ds = d_inner(cfg), cfg.ssm_d_state
    xi, z = torch.chunk(p.in_proj(x, ctx), 2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xc, conv_state = causal_conv(xi, p.conv_w.to(xi.dtype), conv_state)
    xc = xc * torch.sigmoid(xc)                         # jax.nn.silu

    delta, b_, c_ = ssm_coeffs(p, p.x_proj(xc, ctx))
    a_neg = torch.exp(p.a_log)                          # (di, ds) "A"
    h0 = cache["h"] if cache is not None else torch.zeros(
        (b, di, ds), dtype=torch.float32, device=x.device)
    if s == 1 and cache is not None:
        y, h_last = ssm_step(delta[:, 0], xc[:, 0], b_[:, 0], c_[:, 0],
                             a_neg, h0)
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        xc_p = xc
        if pad:
            delta, xc_p, b_, c_ = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                                   for t in (delta, xc, b_, c_))
        y, h_last = ssm_scan(delta, xc_p, b_, c_, a_neg, h0, chunk)
        y = y[:, :s]

    y = y + xc.float() * p.d
    zf = z.float()
    y = (y * (zf * torch.sigmoid(zf))).to(x.dtype)
    out = p.out_proj(y, ctx)
    new_cache = {"h": h_last, "conv": conv_state} if cache is not None \
        else None
    return out, new_cache

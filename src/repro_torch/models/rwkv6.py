"""RWKV6 "Finch" time-mix: attention-free token mixer with data-dependent
per-channel decay (arXiv:2404.05892); port of ``repro.models.rwkv6``.

Recurrence per head (k,r: (hs,), v: (hs,), state S: (hs_k, hs_v)):
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t S_{t-1} + (r_t . (u (*) k_t)) v_t

Prefill evaluates it chunk by chunk (:func:`wkv_scan`): within a chunk the
pairwise decay products are taken in log space, ``exp(L_{t-1} - L_j)``
(j < t) with ``L_t = cumsum(log w)``, bounded in (0, 1]; the carried state
is O(1) in sequence length.  A single-token decode with a cache takes the
recurrence itself (:func:`wkv_step`).  The WKV is plain tensor code in the
reference too (no Pallas kernel), so here it is plain torch.

As in the reference, the five token-shift interpolations use static
learned mu's; the decay keeps its data-dependent LoRA form.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import PimContext, PimLinear

LORA = 64           # rank of the decay LoRA


def dims(cfg: ModelConfig):
    """(heads, head size)."""
    hs = cfg.rwkv_head_size
    return cfg.d_model // hs, hs


class HeadNormAffine(nn.Module):
    """The f32 scale and bias applied after the per-head normalisation
    (the reference's ``ln_x`` dict)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(d, **kw), requires_grad=False)


class RWKV6TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, prefix: str, dtype, device=None):
        super().__init__()
        h, hs = dims(cfg)
        d, da = cfg.d_model, h * hs
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(dtype=dtype, device=device)

        def param(*shape, **dt):
            return nn.Parameter(torch.empty(*shape, **dt),
                                requires_grad=False)

        self.mu = param(5, d, **f32)                  # r,k,v,w,g token shift
        self.w_r = PimLinear(d, da, name=f"{prefix}/w_r", **kw)
        self.w_k = PimLinear(d, da, name=f"{prefix}/w_k", **kw)
        self.w_v = PimLinear(d, da, name=f"{prefix}/w_v", **kw)
        self.w_g = PimLinear(d, da, name=f"{prefix}/w_g", **kw)
        self.decay_w = param(da, **f32)
        self.decay_lora_a = param(d, LORA, **kw)
        self.decay_lora_b = param(LORA, da, **kw)
        self.bonus_u = param(da, **f32)
        self.w_o = PimLinear(da, d, name=f"{prefix}/w_o", **kw)
        self.ln_x = HeadNormAffine(da, device)

    def forward(self, x, ctx: PimContext, cache: Optional[dict] = None):
        return apply_rwkv(self, x, ctx, cache=cache)


def chunk_wkv(r, k, v, logw, u, s0):
    """One chunk.  r,k,v,logw: (B,H,c,hs); u: (H,hs); s0: (B,H,hs,hs).
    Returns (out (B,H,c,hs), s_end)."""
    c = r.shape[2]
    l_ = torch.cumsum(logw, dim=2)                      # L_t, t = 1..c
    l_prev = l_ - logw                                  # L_{t-1}
    # inter-chunk: r_t (*) exp(L_{t-1}) applied to the carried state
    inter = torch.einsum("bhtk,bhkv->bhtv", r * torch.exp(l_prev), s0)
    # intra-chunk pairwise: att[t,j] = sum_k r_tk k_jk exp(L_{t-1,k}-L_{j,k})
    dmat = torch.exp(l_prev[:, :, :, None, :] - l_[:, :, None, :, :])
    att = torch.einsum("bhtk,bhjk,bhtjk->bhtj", r, k, dmat)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)                      # j < t strictly
    att = torch.where(mask, att, 0.0)
    intra = torch.einsum("bhtj,bhjv->bhtv", att, v)
    # current-token bonus: (r_t . (u (*) k_t)) v_t
    bonus = torch.einsum("bhtk,bhtk->bht", r, u[None, :, None, :] * k)
    out = inter + intra + bonus[..., None] * v
    # the state to carry: diag(exp(L_c)) s0 + sum_j (k_j exp(L_c-L_j))^T v_j
    l_c = l_[:, :, -1:, :]                              # (B,H,1,hs)
    kd = k * torch.exp(l_c - l_)
    s_end = torch.exp(l_c[:, :, 0])[..., None] * s0 + \
        torch.einsum("bhjk,bhjv->bhkv", kd, v)
    return out, s_end


def wkv_scan(r, k, v, logw, u, s0, chunk: int):
    """r,k,v,logw: (B,H,S,hs) f32, S a multiple of ``chunk``: the chunks in
    order, carrying the state.  Returns (out (B,H,S,hs), s_end)."""
    outs = []
    s_c = s0
    for c0 in range(0, r.shape[2], chunk):
        sl = slice(c0, c0 + chunk)
        out, s_c = chunk_wkv(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                             logw[:, :, sl], u, s_c)
        outs.append(out)
    return torch.cat(outs, dim=2), s_c


def wkv_step(r, k, v, logw, u, s0):
    """The recurrence for one token.  r,k,v,logw: (B,H,hs); s0:
    (B,H,hs,hs).  Returns (out (B,H,1,hs), s_end)."""
    out = torch.einsum("bhk,bhkv->bhv", r, s0) + \
        torch.einsum("bhk,bhk->bh", r, u * k)[..., None] * v
    s_end = torch.exp(logw)[..., None] * s0 + k[..., None] * v[:, :, None]
    return out[:, :, None, :], s_end


def wkv(r, k, v, logw, u, s0, chunk: int):
    """The chunked scan over any S: S is padded on the right to a multiple
    of the chunk with zeros, whose log-decay 0 (w = 1) leaves the state
    as it is, and the padding's outputs are dropped."""
    s = r.shape[2]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, logw))
    out, s_end = wkv_scan(r, k, v, logw, u, s0, chunk)
    return out[:, :, :s], s_end


def head_norm(y, ln_x: HeadNormAffine, h: int, hs: int):
    """Per-head normalisation with the population variance, then the f32
    ``ln_x`` affine.  y: (B,S,H*hs) f32."""
    b, s, _ = y.shape
    yh = y.reshape(b, s, h, hs)
    mu = torch.mean(yh, -1, keepdim=True)
    var = torch.var(yh, -1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    return yh.reshape(b, s, h * hs) * ln_x.scale + ln_x.bias


def apply_rwkv(p: RWKV6TimeMix, x, ctx: PimContext, *,
               cache: Optional[dict] = None):
    """x: (B,S,D).  cache: {'s': (B,H,hs,hs) f32, 'x_prev': (B,1,D)}.
    Returns (out, new_cache or None).  The dtype order is the reference's:
    the shift runs in the input dtype, r/k/v widen to f32 after their
    projections and g does not, y returns to the input dtype before the
    gate."""
    b, s, d = x.shape
    h, hs = dims(ctx.cfg)
    x_prev = cache["x_prev"] if cache is not None else x.new_zeros((b, 1, d))
    # torch.cat promotes as jnp.concatenate does (a bf16 x_prev before f32
    # activations gives f32)
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)          # token shift
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))

    r = p.w_r(xr, ctx).float()
    k = p.w_k(xk, ctx).float()
    v = p.w_v(xv, ctx).float()
    g = p.w_g(xg, ctx)
    # data-dependent decay (the Finch feature): w in (0,1), log w <= 0
    lora = torch.tanh(xw.float() @ p.decay_lora_a.float()) @ \
        p.decay_lora_b.float()
    logw = -torch.exp(p.decay_w + lora)                 # (B,S,da)

    def to_heads(t):
        return t.reshape(b, s, h, hs).transpose(1, 2)

    r_, k_, v_, w_ = map(to_heads, (r, k, v, logw))
    u = p.bonus_u.reshape(h, hs)
    s0 = cache["s"] if cache is not None else torch.zeros(
        (b, h, hs, hs), dtype=torch.float32, device=x.device)
    if s == 1 and cache is not None:
        y, s_end = wkv_step(*(t[:, :, 0] for t in (r_, k_, v_, w_)), u, s0)
    else:
        y, s_end = wkv(r_, k_, v_, w_, u, s0, ctx.cfg.rwkv_chunk)

    y = head_norm(y.transpose(1, 2).reshape(b, s, h * hs), p.ln_x, h, hs)
    y = y.to(x.dtype) * (g * torch.sigmoid(g))
    out = p.w_o(y, ctx)
    new_cache = {"s": s_end, "x_prev": x[:, -1:]} if cache is not None \
        else None
    return out, new_cache

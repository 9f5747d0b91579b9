"""GQA attention: full and chunked (online-softmax) attention for prefill,
single-step cached decode, the continued-prefill (prefix reuse) branch, and
the enc-dec cross-attention (port of ``repro.models.attention``; attention
is plain tensor code in the reference too).

Layouts are the reference's: q (B, S, KV, G, hd) grouped by KV head, k/v
and caches (B, S, KV, hd).  Under the context-parallel layout
(``fsdp_cp``, ``dist.group``) a rank holds its block of the sequence:
its q rows attend at their absolute offset to the keys and values
gathered whole, and a cache is written whole from them.  A meshed decode
step holds its share of the heads (``dist.group.split_heads``, the
reference's ``"kv"``/``"heads"`` constraints): the projections run whole,
the rank writes and attends its share of the cache (self- and
cross-attention) and gathers the output's heads before ``wo``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..dist import group
from ..dist.sharding import active_mesh
from ..kernels.decode_attn import attn_scores, attn_values
from .layers import PimContext, PimLinear, apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    """wq, wk, wv and wo; ``bias`` defaults to ``cfg.attn_bias``.  The
    cross-attention of an enc-dec layer is the same module (its wk/wv
    project the encoder output once, :func:`encoder_kv`)."""

    def __init__(self, cfg: ModelConfig, prefix: str, dtype, device=None,
                 bias: Optional[bool] = None):
        super().__init__()
        hd = cfg.hd
        bias = cfg.attn_bias if bias is None else bias
        kw = dict(dtype=dtype, device=device, bias=bias)
        self.wq = PimLinear(cfg.d_model, cfg.n_heads * hd,
                            name=f"{prefix}/wq", **kw)
        self.wk = PimLinear(cfg.d_model, cfg.n_kv_heads * hd,
                            name=f"{prefix}/wk", **kw)
        self.wv = PimLinear(cfg.d_model, cfg.n_kv_heads * hd,
                            name=f"{prefix}/wv", **kw)
        self.wo = PimLinear(cfg.n_heads * hd, cfg.d_model,
                            name=f"{prefix}/wo", **kw)

    def forward(self, x, ctx: PimContext, positions, *,
                cache: Optional[dict] = None, cont: bool = False,
                causal: bool = True, rope: bool = True):
        return apply_attention(self, x, ctx, positions, cache=cache,
                               cont=cont, causal=causal, rope=rope)


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd) for GQA."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _whole(s):
    return s


def full_attention(q, k, v, causal: bool, q_off=0) -> torch.Tensor:
    """q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd).  ``q_off`` shifts the causal
    mask by the absolute position of q row 0 (an int or a (B,) tensor)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        off = torch.as_tensor(q_off, dtype=torch.int32,
                              device=q.device).reshape(-1, 1, 1)
        mask = (torch.arange(sq, device=q.device)[None, :, None] + off) >= \
            torch.arange(sk, device=q.device)[None, None, :]
        s = torch.where(mask[:, None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", a, v.float())
    return o.to(q.dtype)


def chunked_attention(q, k, v, causal: bool, chunk_q: int,
                      chunk_k: int, q_off: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention with all q chunks batched.
    q: (B,Sq,KV,G,hd); k/v: (B,Sk,KV,hd); Sk divides by ``chunk_k``.
    ``q_off`` is the absolute position of q row 0 (a rank's block of the
    sequence, the reference's ``context_parallel``): the causal mask is
    by absolute position, and a block that ``chunk_q`` does not divide is
    one q chunk (each row's arithmetic is its own either way)."""
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5
    if sq % chunk_q:
        chunk_q = sq
    nq, nk = sq // chunk_q, sk // chunk_k
    dev = q.device
    qc = q.reshape(b, nq, chunk_q, kv, g, hd).float() * scale
    kc = k.reshape(b, nk, chunk_k, kv, hd)
    vc = v.reshape(b, nk, chunk_k, kv, hd)
    m = torch.full((b, nq, kv, g, chunk_q), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, nq, kv, g, chunk_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, kv, g, chunk_q, hd), dtype=torch.float32,
                      device=dev)
    qpos = (torch.arange(nq, device=dev)[:, None] * chunk_q
            + torch.arange(chunk_q, device=dev)[None, :]) + q_off   # (nq, cq)
    for j in range(nk):
        sc = torch.einsum("bnqkgd,bskd->bnkgqs", qc, kc[:, j].float())
        if causal:
            kpos = j * chunk_k + torch.arange(chunk_k, device=dev)
            mask = qpos[..., None] >= kpos[None, None, :]       # (nq,cq,ck)
            sc = torch.where(mask[None, :, None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnkgqs,bskd->bnkgqd", p, vc[:, j].float())
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]   # (b, nq, kv, g, cq, hd)
    out = o.movedim(4, 2).reshape(b, sq, kv, g, hd)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, scale=None,
                     reduce=_whole) -> torch.Tensor:
    """One-token attention against a cache.  q: (B,1,KV,G,hd); caches:
    (B,S,KV,hd); cache_len: (B,) valid entries (the new token included).
    ``scale`` defaults to ``hd ** -0.5``; ``reduce`` turns the scores of a
    share of the head dims into the whole heads'.

    The reference dots the cache in its own dtype with f32 accumulation
    (``preferred_element_type``): here q is rounded to the cache dtype and
    both operands are widened to f32 before the product, which is the same
    arithmetic (a bf16 matmul would round its output to bf16).  On the
    card both halves are ``kernels.decode_attn``'s, whose sums run in an
    order fixed by one head's shapes, so a rank's share of the heads gives
    the whole call's bits."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(k_cache.dtype).float()
    s = reduce(attn_scores(qs, k_cache))
    return attn_values(s, v_cache, cache_len, round_a=True).to(q.dtype)


def cross_decode_attention(q, k, v, scale=None,
                           reduce=_whole) -> torch.Tensor:
    """:func:`full_attention` of one query row, never causal (a decode
    step's cross-attention): q: (B,1,KV,G,hd), k/v: (B,Se,KV,hd); on the
    card through ``kernels.decode_attn`` as :func:`decode_attention`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = reduce(attn_scores(q.float() * scale, k))
    return attn_values(s, v).to(q.dtype)


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Write new (B,s,KV,hd) at per-batch time index idx into (B,S,KV,hd),
    clamping the start so the window fits (the reference's
    dynamic_update_slice semantics).  Functional: returns a new tensor."""
    b, s_new = new.shape[:2]
    start = torch.clamp(idx.long(), 0, cache.shape[1] - s_new)
    pos = start[:, None] + torch.arange(s_new, device=cache.device)[None]
    pos = pos[:, :, None, None].expand(b, s_new, *cache.shape[2:])
    return cache.scatter(1, pos, new.to(cache.dtype))


def apply_attention(p: Attention, x, ctx: PimContext, positions, *,
                    causal: bool = True, cache: Optional[dict] = None,
                    cont: bool = False, rope: bool = True):
    """Returns (out, new_cache).  cache=None -> stateless.  Prefill (s > 1)
    writes k/v at [0, s); decode (s == 1) writes at cache['len'];
    ``cont`` appends the s tokens at cache['len'] and attends over the
    whole (trimmed) cache buffer.  ``rope=False`` leaves q and k unrotated
    (``positions`` is then unused).  While the sequence is split
    (``dist.group.seq_is_split``), ``x`` is this rank's block: k and v are
    gathered whole after RoPE, every choice is the whole sequence's, and
    the q rows attend at their absolute offset.  In a decode step that
    holds a share of the heads (``dist.group.heads_held``), ``cache`` is
    that share: the rank writes and attends its share of q, k and v, and
    gathers the output's heads."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    hd = cfg.hd
    q = p.wq(x, ctx).reshape(b, s, cfg.n_heads, hd)
    k = p.wk(x, ctx).reshape(b, s, cfg.n_kv_heads, hd)
    v = p.wv(x, ctx).reshape(b, s, cfg.n_kv_heads, hd)
    if rope:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    off = group.seq_offset(s)
    if group.seq_is_split():
        # the reference's shard(k, "batch", None, None, None)
        k, v = group.gather_seq(k, 1), group.gather_seq(v, 1)
        s = s * group.seq_size(active_mesh())
    qg = _group_q(q, cfg.n_kv_heads)
    new_cache = None
    ck = min(s, cfg.attn_chunk_k)
    chunked = s > cfg.attn_chunk_q and s % cfg.attn_chunk_q == 0 and \
        s % ck == 0

    if cont and cache is not None and s > 1:
        idx = cache["len"]
        k_cache = _scatter_time(cache["k"], k, idx)
        v_cache = _scatter_time(cache["v"], v, idx)
        new_cache = {"k": k_cache, "v": v_cache, "len": idx + s}
        o = full_attention(qg, k_cache, v_cache, causal, q_off=idx + off)
    elif cache is None:
        o = chunked_attention(qg, k, v, causal, cfg.attn_chunk_q, ck, off) \
            if chunked else full_attention(qg, k, v, causal, off)
    elif s == 1:
        share = group.heads_held()
        reduce = _whole
        if share is not None:
            qg, k, v = share.queries(qg), share.keys(k), share.keys(v)
            reduce = share.scores
        idx = cache["len"]
        k_cache = _scatter_time(cache["k"], k, idx)
        v_cache = _scatter_time(cache["v"], v, idx)
        new_cache = {"k": k_cache, "v": v_cache, "len": idx + 1}
        o = decode_attention(qg, k_cache, v_cache, idx + 1, hd ** -0.5,
                             reduce)
        if share is not None:
            o = share.out(o)
    else:
        pad = cache["k"].shape[1] - s
        kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        new_cache = {"k": kf.to(cache["k"].dtype),
                     "v": vf.to(cache["v"].dtype),
                     "len": torch.full((b,), s, dtype=torch.int32,
                                       device=x.device)}
        o = chunked_attention(qg, k, v, causal, cfg.attn_chunk_q, ck, off) \
            if chunked else full_attention(qg, k, v, causal, off)

    o = o.reshape(b, o.shape[1], cfg.n_heads * hd)
    return p.wo(o, ctx), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)
# ---------------------------------------------------------------------------

def apply_cross_attention(p: Attention, x, enc_kv: dict,
                          ctx: PimContext) -> torch.Tensor:
    """x: (B,Sd,D); enc_kv: {'k','v'} (B,Se,KV,hd) precomputed from the
    encoder.  Chunked when both lengths divide by their chunks and one
    exceeds it, else full; never causal, never masked: every row of
    ``enc_kv`` enters the softmax.  In a decode step that holds a share of
    the heads, ``enc_kv`` is that share of the cross-KV: the rank attends
    its share of q and gathers the output's heads."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    hd = cfg.hd
    q = p.wq(x, ctx).reshape(b, s, cfg.n_heads, hd)
    qg = _group_q(q, cfg.n_kv_heads)
    share = group.heads_held()
    se = enc_kv["k"].shape[1]
    cq, ck = cfg.attn_chunk_q, cfg.attn_chunk_k
    if s == 1:                     # a decode step's row (cq > 1: unchunked)
        if share is None:
            o = cross_decode_attention(qg, enc_kv["k"], enc_kv["v"])
        else:
            o = share.out(cross_decode_attention(
                share.queries(qg), enc_kv["k"], enc_kv["v"], hd ** -0.5,
                share.scores))
    elif s % cq == 0 and se % ck == 0 and (s > cq or se > ck):
        o = chunked_attention(qg, enc_kv["k"], enc_kv["v"], False, cq, ck)
    else:
        o = full_attention(qg, enc_kv["k"], enc_kv["v"], causal=False)
    return p.wo(o.reshape(b, s, cfg.n_heads * hd), ctx)


def encoder_kv(p: Attention, enc_out, ctx: PimContext) -> dict:
    """The cross-attention keys and values of one decoder layer:
    {'k','v'} (B,Se,KV,hd)."""
    cfg = ctx.cfg
    b, s, _ = enc_out.shape
    k = p.wk(enc_out, ctx).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = p.wv(enc_out, ctx).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return {"k": k, "v": v}

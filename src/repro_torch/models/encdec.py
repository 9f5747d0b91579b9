"""Whisper-style encoder-decoder (port of ``repro.models.encdec``; the conv
frontend is a stub there too: callers supply precomputed frame embeddings).

Encoder: the frame projection, sinusoidal positions, bidirectional
rope-free attention and a GELU MLP, every projection biased.  Decoder:
causal rope-free self-attention, cross-attention to the encoder output, and
the MLP; logits are an f32 product with the tied embedding table.

The reference scans both stacks; the port loops over ``enc`` and ``dec``.
In train mode with gradients on, ``cfg.remat`` (any value but ``none``,
as the reference's ``jax.checkpoint`` of both scan bodies) recomputes each
encoder and decoder layer in backward (``torch.utils.checkpoint``,
non-reentrant) with A/D metering muted (``PimContext.remat_contexts``);
the cross-KV projections run outside the checkpointed bodies, as in the
reference.
Every projection of a stack shares one QuantState name with no depth
(``enc/attn/wq``, ``dec/xattn/wk``, ``frontend/frame_proj``), as the
reference's scanned stacks do.  The serving cache is one dict::

    {"k", "v":   (L, B, S, KV, hd)   self-attention KV, S = max_len,
     "xk", "xv": (L, B, E, KV, hd)   cross-attention KV, E = enc_len,
     "len": (B,) int32, "len0": (B,) int32}

``k``/``v``/``xk``/``xv`` scale with the cache length (``paged_keys``);
``xk``/``xv`` are written at prefill only (``STATIC_KEYS``).  Decode
positions start at ``len0``.  At decode, cross-attention reads the whole
``E``-row buffer, zero past the real frames, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import Attention, apply_cross_attention, encoder_kv
from .layers import (MLP, Embed, LayerNorm, PimContext, PimLinear, cdtype,
                     no_aux, pdtype, sinusoid_at, sinusoid_pos)
from .lm import REMAT

STATIC_KEYS = ("xk", "xv")      # cache leaves written at prefill only


def paged_keys(cfg: ModelConfig) -> tuple:
    """Cache leaves that scale with the cache length."""
    return ("k", "v") + STATIC_KEYS


def _run(layer, remat: bool, ctx: PimContext, *args, **kw):
    """``layer(*args, **kw)``, recomputed in backward when ``remat`` (the
    recompute counts no A/D ops)."""
    if not remat:
        return layer(*args, **kw)
    return checkpoint(layer, *args, use_reentrant=False,
                      context_fn=ctx.remat_contexts, **kw)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = Attention(cfg, "enc/attn", dtype, device, bias=True)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, "enc/mlp", dtype, device, bias=True)

    def forward(self, x, ctx: PimContext):
        eps = ctx.cfg.norm_eps
        o, _ = self.attn(self.ln1(x, eps), ctx, None, causal=False,
                         rope=False)
        x = x + o
        return x + self.mlp(self.ln2(x, eps), ctx)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = Attention(cfg, "dec/attn", dtype, device, bias=True)
        self.ln_x = LayerNorm(cfg.d_model, device)
        self.xattn = Attention(cfg, "dec/xattn", dtype, device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, "dec/mlp", dtype, device, bias=True)

    def forward(self, x, ctx: PimContext, xkv: dict, cache=None):
        eps = ctx.cfg.norm_eps
        o, new_cache = self.attn(self.ln1(x, eps), ctx, None, cache=cache,
                                 rope=False)
        x = x + o
        x = x + apply_cross_attention(self.xattn, self.ln_x(x, eps), xkv,
                                      ctx)
        return x + self.mlp(self.ln2(x, eps), ctx), new_cache


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.frontend not in ("none", "frames"):
            raise NotImplementedError(f"{cfg.name}: frontend "
                                      f"{cfg.frontend!r} is not ported")
        self.cfg = cfg
        dt = pdtype(cfg)
        self.frontend = nn.ModuleDict({"frame_proj": PimLinear(
            cfg.d_model, cfg.d_model, name="frontend/frame_proj", bias=True,
            dtype=dt, device=device)})
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, device)
        self.enc = nn.ModuleList([EncoderLayer(cfg, dt, device)
                                  for _ in range(cfg.encoder_layers)])
        self.enc_norm = LayerNorm(cfg.d_model, device)
        self.dec = nn.ModuleList([DecoderLayer(cfg, dt, device)
                                  for _ in range(cfg.n_layers)])
        self.dec_norm = LayerNorm(cfg.d_model, device)
        for path, mod in self.named_modules():
            if isinstance(mod, PimLinear):
                mod.path = path

    def remat(self, mode: str) -> bool:
        """Whether this forward recomputes its layers in backward."""
        return mode == "train" and self.cfg.remat in REMAT and \
            torch.is_grad_enabled()

    def encode(self, frames: torch.Tensor, ctx: PimContext,
               remat: bool = False) -> torch.Tensor:
        """frames: (B, T, D) precomputed frame embeddings."""
        cfg = self.cfg
        x = self.frontend["frame_proj"](frames.to(cdtype(cfg)), ctx)
        x = x + sinusoid_pos(x.shape[1], cfg.d_model, x.dtype,
                             x.device)[None]
        for layer in self.enc:
            x = _run(layer, remat, ctx, x, ctx)
        return self.enc_norm(x, cfg.norm_eps)

    def cross_kv(self, enc_out: torch.Tensor, ctx: PimContext) -> list:
        """Every decoder layer's cross-attention {'k','v'}."""
        return [encoder_kv(layer.xattn, enc_out, ctx) for layer in self.dec]

    def decode_stack(self, tokens, ctx: PimContext, xkv: list, *,
                     cache: Optional[dict] = None, mode: str = "train"):
        """The decoder over ``tokens`` (B, Sd) against the per-layer
        cross-KV ``xkv``: (logits f32, {'k','v','len','len0'} or None).
        Decode positions are ``cache['len0']``, others ``0..Sd-1``."""
        cfg = self.cfg
        x = self.embed(tokens).to(cdtype(cfg))
        b, s, _ = x.shape
        if mode == "decode" and cache is not None:
            positions = cache["len0"][:, None]
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        x = x + sinusoid_at(positions, cfg.d_model).to(x.dtype)
        stacks: dict = {"k": [], "v": []}
        new_len = None
        for i, layer in enumerate(self.dec):
            lc = None if cache is None else {
                "k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
            x, nc = _run(layer, self.remat(mode), ctx, x, ctx, xkv[i],
                         cache=lc)
            if nc is not None:
                stacks["k"].append(nc["k"])
                stacks["v"].append(nc["v"])
                new_len = nc["len"]
        x = self.dec_norm(x, cfg.norm_eps)
        if mode in ("decode", "prefill"):
            x = x[:, -1:]          # serving: next-token logits only
        logits = x.float() @ self.embed.tok.float().T
        if cache is None:
            return logits, None
        return logits, {"k": torch.stack(stacks["k"]),
                        "v": torch.stack(stacks["v"]), "len": new_len,
                        "len0": cache["len0"] + (1 if mode == "decode"
                                                 else s)}

    def forward(self, tokens: torch.Tensor, ctx: PimContext, *,
                cache: Optional[dict] = None, mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None):
        """``embeds`` (B, T, D) frames for train/prefill; decode reads the
        cross-KV from ``cache``.  Returns (logits f32, new_cache or None,
        aux 0.0 f32: no MoE layer); the prefill's cross-KV is zero-padded
        out to the cache's ``E`` rows (kept in the compute dtype, as the
        reference keeps it)."""
        if mode == "prefill_cont":
            raise NotImplementedError(
                "enc-dec has no continued prefill (prefix reuse is off)")
        if mode == "decode":
            n = len(self.dec)
            xkv = [{"k": cache["xk"][i], "v": cache["xv"][i]}
                   for i in range(n)]
            logits, nc = self.decode_stack(tokens, ctx, xkv, cache=cache,
                                           mode=mode)
            nc.update(xk=cache["xk"], xv=cache["xv"])
            return logits, nc, no_aux(logits.device)
        if embeds is None:
            raise ValueError(f"{self.cfg.name}: {mode} needs the frame "
                             f"embeddings ('embeds')")
        xkv = self.cross_kv(self.encode(embeds, ctx, self.remat(mode)), ctx)
        logits, nc = self.decode_stack(tokens, ctx, xkv, cache=cache,
                                       mode=mode)
        if nc is not None:
            for key, leaf in (("xk", "k"), ("xv", "v")):
                t = torch.stack([kv[leaf] for kv in xkv])
                pad = cache[key].shape[2] - t.shape[2]
                nc[key] = torch.nn.functional.pad(
                    t, (0, 0, 0, 0, 0, pad)) if pad > 0 else t
        return logits, nc, no_aux(logits.device)


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The slot-resident leaves: the self-KV length and the decoder
    position."""
    z = dict(dtype=torch.int32, device=device)
    return {"len": torch.zeros((batch,), **z),
            "len0": torch.zeros((batch,), **z)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               enc_len: Optional[int] = None) -> dict:
    """Zeroed self-KV and cross-KV; ``enc_len`` defaults to ``max_len``
    (the reference's rule)."""
    enc_len = max_len if enc_len is None else enc_len
    out = {}
    for keys, rows in ((("k", "v"), max_len), (STATIC_KEYS, enc_len)):
        shape = (cfg.n_layers, batch, rows, cfg.n_kv_heads, cfg.hd)
        for key in keys:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
    out.update(init_state(cfg, batch, dtype, device))
    return out

"""Decoder-only LM: the dense GQA decoder and the attention-free rwkv6
decoder of ``repro.models.lm``.

The reference scans the layer stack over periods; the port runs a Python
loop over ``layers``.  The cache is one dict of tensors, each stacked over
the layers that hold it::

    {"k": (La, B, S, KV, hd), "v": (La, B, S, KV, hd), "len": (B,) int32}
    {"s": (Lr, B, H, hs, hs) f32, "x_prev": (Lr, B, 1, D)}

with ``La`` attention layers and ``Lr`` rwkv layers; a model has only the
leaves of the mixers it holds.  ``k``/``v`` scale with ``max_len`` (the
paged leaves, ``PAGED_KEYS``); the rest are O(1) per sequence.

Modes: train | prefill | prefill_cont | decode.  Serving modes return only
the last position's logits; with tied embeddings the logits are an f32
``torch.matmul`` against the embedding table, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import Attention
from .layers import (MLP, Embed, PimContext, PimLinear, RMSNorm, cdtype,
                     pdtype)
from .rwkv6 import RWKV6TimeMix, dims as rwkv_dims

LAYER_KINDS = (("attn", "mlp"), ("rwkv", "mlp"))
PAGED_KEYS = ("k", "v")         # cache leaves that scale with max_len
STATIC_KEYS = ()                # none is written at prefill only


def layer_name(cfg: ModelConfig, depth: int) -> str:
    """QuantState name prefix of the layer at ``depth``: period-local under
    ``scan_layers`` (periods share registers), per-depth otherwise."""
    return f"layer_{depth % cfg.period if cfg.scan_layers else depth}"


def mixers(cfg: ModelConfig) -> list:
    """The token mixer of every layer, by depth."""
    return [cfg.layer_kind(i % cfg.period)[0] for i in range(cfg.n_layers)]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, depth: int, dtype, device=None):
        super().__init__()
        kind = cfg.layer_kind(depth % cfg.period)
        if kind not in LAYER_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind} is not ported; ported: "
                f"{LAYER_KINDS}")
        self.mixer = kind[0]
        lname = layer_name(cfg, depth)
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if self.mixer == "attn":
            self.attn = Attention(cfg, f"{lname}/attn", dtype, device)
        else:
            self.rwkv = RWKV6TimeMix(cfg, f"{lname}/rwkv", dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg, f"{lname}/mlp", dtype, device)

    def forward(self, x, ctx: PimContext, positions, cache=None,
                cont: bool = False):
        eps = ctx.cfg.norm_eps
        h = self.norm1(x, eps)
        if self.mixer == "attn":
            o, new_cache = self.attn(h, ctx, positions, cache=cache,
                                     cont=cont)
        else:
            o, new_cache = self.rwkv(h, ctx, cache=cache)
        x = x + o
        x = x + self.mlp(self.norm2(x, eps), ctx)
        return x, new_cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in ("dense", "ssm") or cfg.frontend != "none" \
                or cfg.encoder_layers:
            raise NotImplementedError(f"{cfg.name}: only the dense and the "
                                      f"rwkv6 decoders are ported")
        self.cfg = cfg
        dt = pdtype(cfg)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, i, dt, device) for i in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.lm_head = None if cfg.tie_embeddings else PimLinear(
            cfg.d_model, cfg.vocab_size, name="lm_head", dtype=dt,
            device=device)
        for path, mod in self.named_modules():
            if isinstance(mod, PimLinear):
                mod.path = path

    def forward(self, tokens: torch.Tensor, ctx: PimContext, *,
                cache: Optional[dict] = None, mode: str = "train",
                positions: Optional[torch.Tensor] = None):
        """Returns (logits f32, new_cache or None)."""
        cfg = self.cfg
        cont = mode == "prefill_cont"
        x = self.embed(tokens).to(cdtype(cfg))
        b, s, _ = x.shape
        if positions is None:
            if mode == "decode" and cache is not None:
                # attention-free models use no positions: zeros, as the
                # reference's _first_len
                positions = cache["len"][:, None] if "len" in cache else \
                    torch.zeros((b, 1), dtype=torch.int32, device=x.device)
            else:
                positions = torch.arange(s, dtype=torch.int32,
                                         device=x.device)[None].expand(b, s)
        stacks: dict = {}
        new_len = None
        index = {"attn": 0, "rwkv": 0}      # depth among the same mixers
        for layer in self.layers:
            lc = None
            if cache is not None:
                i = index[layer.mixer]
                lc = {key: cache[key][i] for key in
                      (PAGED_KEYS if layer.mixer == "attn"
                       else ("s", "x_prev"))}
                if layer.mixer == "attn":
                    lc["len"] = cache["len"]
            index[layer.mixer] += 1
            x, nc = layer(x, ctx, positions, cache=lc, cont=cont)
            if nc is not None:
                for key, val in nc.items():
                    if key == "len":
                        new_len = val
                    else:
                        stacks.setdefault(key, []).append(val)
        x = self.final_norm(x, cfg.norm_eps)
        if mode in ("decode", "prefill", "prefill_cont"):
            x = x[:, -1:]
        if self.lm_head is None:
            logits = x.float() @ self.embed.tok.float().T
        else:
            logits = self.lm_head(x, ctx).float()
        new_cache = None
        if cache is not None:
            new_cache = {key: torch.stack(v) for key, v in stacks.items()}
            if new_len is not None:
                new_cache["len"] = new_len
        return logits, new_cache


def paged_keys(cfg: ModelConfig) -> tuple:
    """The cache leaves this model has that scale with ``max_len``."""
    return PAGED_KEYS if "attn" in mixers(cfg) else ()


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The zeroed cache leaves that do not scale with ``max_len``: ``len``
    for attention layers, ``s`` and ``x_prev`` for rwkv layers."""
    kinds = mixers(cfg)
    out = {}
    if "attn" in kinds:
        out["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    n_rwkv = kinds.count("rwkv")
    if n_rwkv:
        h, hs = rwkv_dims(cfg)
        out["s"] = torch.zeros((n_rwkv, batch, h, hs, hs),
                               dtype=torch.float32, device=device)
        out["x_prev"] = torch.zeros((n_rwkv, batch, 1, cfg.d_model),
                                    dtype=dtype, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty cache with only the leaves the model has (bf16 K/V and
    ``x_prev`` by default, as the reference's)."""
    n_attn = mixers(cfg).count("attn")
    out = {}
    if n_attn:
        shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.hd)
        out = {key: torch.zeros(shape, dtype=dtype, device=device)
               for key in PAGED_KEYS}
    out.update(init_state(cfg, batch, dtype, device))
    return out

"""Decoder-only LM: the dense GQA decoder (with or without the vlm's patch
frontend), the MoE decoder (an expert FFN in place of the MLP, or beside
it with a dense residual), the attention-free rwkv6 decoder and the
mamba/attention hybrid (jamba) of ``repro.models.lm``.

The reference scans the layer stack over periods; the port runs a Python
loop over ``layers``.  The cache is one dict of tensors, each stacked over
the layers that hold it::

    {"k": (La, B, S, KV, hd), "v": (La, B, S, KV, hd), "len": (B,) int32}
    {"s": (Lr, B, H, hs, hs) f32, "x_prev": (Lr, B, 1, D)}
    {"h": (Lm, B, di, ds) f32, "conv": (Lm, B, dc-1, di)}

with ``La`` attention layers, ``Lr`` rwkv layers and ``Lm`` mamba layers;
a model has only the leaves of the mixers it holds (jamba has both K/V
and mamba state).  ``k``/``v`` scale with ``max_len`` (the
paged leaves, ``PAGED_KEYS``); the rest are O(1) per sequence.

Modes: train | prefill | prefill_cont | decode.  Serving modes return only
the last position's logits; with tied embeddings the logits are an f32
``torch.matmul`` against the embedding table, as in the reference.  Every
mode also returns the MoE layers' Switch loss summed in layer order (f32;
0.0 without MoE layers).  In train mode with gradients on, ``cfg.remat``
(``block``, ``full`` or ``names``) recomputes each layer in backward
(``torch.utils.checkpoint``, non-reentrant) with A/D metering muted and
the forward's mesh and row split reinstalled (the recompute may run on
autograd's device thread): the same numbers, each forward conversion
counted once.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist import group
from ..dist.sharding import active_mesh
from .attention import Attention
from .layers import (MLP, Embed, PimContext, PimLinear, RMSNorm, cdtype,
                     no_aux, pdtype)
from .mamba import MambaMixer, d_inner
from .moe import MoE
from .rwkv6 import RWKV6TimeMix, dims as rwkv_dims

REMAT = ("block", "full", "names")   # cfg.remat values that recompute
LAYER_KINDS = (("attn", "mlp"), ("attn", "moe"), ("attn", "moe+mlp"),
               ("rwkv", "mlp"), ("mamba", "mlp"), ("mamba", "moe"))
PAGED_KEYS = ("k", "v")         # cache leaves that scale with max_len
STATIC_KEYS = ()                # none is written at prefill only
# each mixer's cache leaves, stacked over the layers of that mixer
STATE_KEYS = {"attn": PAGED_KEYS, "rwkv": ("s", "x_prev"),
              "mamba": ("h", "conv")}


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
        self.mixer, self.ffn = kind
        lname = layer_name(cfg, depth)
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if self.mixer == "attn":
            self.attn = Attention(cfg, f"{lname}/attn", dtype, device)
        elif self.mixer == "mamba":
            self.mamba = MambaMixer(cfg, f"{lname}/mamba", dtype, device)
        else:
            self.rwkv = RWKV6TimeMix(cfg, f"{lname}/rwkv", dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        if self.ffn in ("mlp", "moe+mlp"):
            self.mlp = MLP(cfg, f"{lname}/mlp", dtype, device)
        if self.ffn in ("moe", "moe+mlp"):
            self.moe = MoE(cfg, dtype, device)

    def forward(self, x, ctx: PimContext, positions, cache=None,
                cont: bool = False):
        """Returns (x, new_cache, the Switch loss or None)."""
        eps = ctx.cfg.norm_eps
        h = self.norm1(x, eps)
        if self.mixer == "attn":
            o, new_cache = self.attn(h, ctx, positions, cache=cache,
                                     cont=cont)
        elif self.mixer == "mamba":
            o, new_cache = self.mamba(h, ctx, cache=cache)
        else:
            o, new_cache = self.rwkv(h, ctx, cache=cache)
        x = x + o
        h = self.norm2(x, eps)
        if self.ffn == "mlp":
            return x + self.mlp(h, ctx), new_cache, None
        mo, aux = self.moe(h)
        if self.ffn == "moe":
            return x + mo, new_cache, aux
        return x + mo + self.mlp(h, ctx), new_cache, aux   # arctic's order


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm") \
                or cfg.frontend not in ("none", "patch") \
                or cfg.encoder_layers:
            raise NotImplementedError(f"{cfg.name}: only the dense, the "
                                      f"MoE, the rwkv6, the hybrid and the "
                                      f"patch-frontend decoders are ported")
        self.cfg = cfg
        dt = pdtype(cfg)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, device)
        # the vlm stub: precomputed patch embeddings, projected and placed
        # as the sequence prefix
        self.frontend = None if cfg.frontend == "none" else nn.ModuleDict(
            {"patch_proj": PimLinear(cfg.d_model, cfg.d_model,
                                     name="frontend/patch_proj", dtype=dt,
                                     device=device)})
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
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None):
        """``embeds`` (B, F, D): patch embeddings, projected at the
        parameter dtype by ``frontend/patch_proj`` and placed before the
        tokens (the reference's ``_embed_inputs``); positions then run
        over all F + S rows.  While a mesh splits the sequence
        (``dist.group.seq_is_split``), this rank runs its block of those
        rows (the reference's ``shard(x, "batch", "seq", None)``): train
        mode returns its rows' logits, the serving modes every rank the
        last position's.  Returns (logits f32, new_cache or None, aux
        f32)."""
        cfg = self.cfg
        cont = mode == "prefill_cont"
        x = self.embed(tokens)
        if embeds is not None:
            if self.frontend is None:
                raise ValueError(f"{cfg.name} has no frontend to take "
                                 f"'embeds'")
            with group.replicated():        # every model rank's F rows
                fe = self.frontend["patch_proj"](embeds.to(x.dtype), ctx)
            x = torch.cat([fe, x], 1)
        x = x.to(cdtype(cfg))
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
        if group.seq_is_split():
            blk = group.seq_share(active_mesh(), cfg, s)
            if blk is None:
                raise ValueError(f"the sequence is marked split but "
                                 f"{cfg.name}'s {s} rows have no block on "
                                 f"the model axis")
            x, positions = x[:, blk], positions[:, blk]
        stacks: dict = {}
        new_len = None
        aux = no_aux(x.device)
        remat = mode == "train" and cfg.remat in REMAT and \
            torch.is_grad_enabled()
        index = dict.fromkeys(STATE_KEYS, 0)  # depth among the same mixers
        for layer in self.layers:
            lc = None
            if cache is not None:
                i = index[layer.mixer]
                lc = {key: cache[key][i] for key in STATE_KEYS[layer.mixer]}
                if layer.mixer == "attn":
                    lc["len"] = cache["len"]
            index[layer.mixer] += 1
            if remat:
                x, nc, a = checkpoint(
                    layer, x, ctx, positions, cache=lc, cont=cont,
                    use_reentrant=False,
                    context_fn=ctx.remat_contexts)
            else:
                x, nc, a = layer(x, ctx, positions, cache=lc, cont=cont)
            if a is not None:
                aux = aux + a
            if nc is not None:
                for key, val in nc.items():
                    if key == "len":
                        new_len = val
                    else:
                        stacks.setdefault(key, []).append(val)
        x = self.final_norm(x, cfg.norm_eps)
        serving = mode in ("decode", "prefill", "prefill_cont")
        if serving:
            # the last rank's last row, on every model rank
            x = group.gather_seq(x[:, -1:], 1)[:, -1:]
        if self.lm_head is None:
            logits = x.float() @ self.embed.tok.float().T
        else:
            with group.replicated() if serving else contextlib.nullcontext():
                logits = self.lm_head(x, ctx).float()
        new_cache = None
        if cache is not None:
            new_cache = {key: torch.stack(v) for key, v in stacks.items()}
            if new_len is not None:
                new_cache["len"] = new_len
        return logits, new_cache, aux


def paged_keys(cfg: ModelConfig) -> tuple:
    """The cache leaves this model has that scale with ``max_len``."""
    return PAGED_KEYS if "attn" in mixers(cfg) else ()


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The zeroed cache leaves that do not scale with ``max_len``: ``len``
    for attention layers, ``s`` and ``x_prev`` for rwkv layers, ``h`` and
    ``conv`` for mamba layers."""
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
    n_mamba = kinds.count("mamba")
    if n_mamba:
        di = d_inner(cfg)
        out["h"] = torch.zeros((n_mamba, batch, di, cfg.ssm_d_state),
                               dtype=torch.float32, device=device)
        out["conv"] = torch.zeros((n_mamba, batch, cfg.ssm_d_conv - 1, di),
                                  dtype=dtype, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty cache with only the leaves the model has (bf16 K/V,
    ``x_prev`` and ``conv`` by default, as the reference's)."""
    n_attn = mixers(cfg).count("attn")
    out = {}
    if n_attn:
        shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.hd)
        out = {key: torch.zeros(shape, dtype=dtype, device=device)
               for key in PAGED_KEYS}
    out.update(init_state(cfg, batch, dtype, device))
    return out

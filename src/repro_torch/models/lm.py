"""Dense decoder-only LM (the dense GQA path of ``repro.models.lm``).

The reference scans the layer stack over periods; the port runs a Python
loop over ``layers``.  The KV cache is one dict of stacked tensors::

    {"k": (L, B, S, KV, hd), "v": (L, B, S, KV, hd), "len": (B,) int32}

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


def layer_name(cfg: ModelConfig, depth: int) -> str:
    """QuantState name prefix of the layer at ``depth``: period-local under
    ``scan_layers`` (periods share registers), per-depth otherwise."""
    return f"layer_{depth % cfg.period if cfg.scan_layers else depth}"


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, depth: int, dtype, device=None):
        super().__init__()
        mixer, ffn = cfg.layer_kind(depth % cfg.period)
        if (mixer, ffn) != ("attn", "mlp"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind {(mixer, ffn)} is not ported; only "
                f"the dense attention+MLP decoder is")
        lname = layer_name(cfg, depth)
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, f"{lname}/attn", dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg, f"{lname}/mlp", dtype, device)

    def forward(self, x, ctx: PimContext, positions, cache=None,
                cont: bool = False):
        eps = ctx.cfg.norm_eps
        o, new_cache = self.attn(self.norm1(x, eps), ctx, positions,
                                 cache=cache, cont=cont)
        x = x + o
        x = x + self.mlp(self.norm2(x, eps), ctx)
        return x, new_cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.frontend != "none" or \
                cfg.encoder_layers:
            raise NotImplementedError(f"{cfg.name}: only dense decoders "
                                      f"are ported")
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
                positions = cache["len"][:, None]
            else:
                positions = torch.arange(s, dtype=torch.int32,
                                         device=x.device)[None].expand(b, s)
        ks, vs, new_len = [], [], None
        for i, layer in enumerate(self.layers):
            lc = None if cache is None else \
                {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]}
            x, nc = layer(x, ctx, positions, cache=lc, cont=cont)
            if nc is not None:
                ks.append(nc["k"])
                vs.append(nc["v"])
                new_len = nc["len"]
        x = self.final_norm(x, cfg.norm_eps)
        if mode in ("decode", "prefill", "prefill_cont"):
            x = x[:, -1:]
        if self.lm_head is None:
            logits = x.float() @ self.embed.tok.float().T
        else:
            logits = self.lm_head(x, ctx).float()
        new_cache = None if cache is None else \
            {"k": torch.stack(ks), "v": torch.stack(vs), "len": new_len}
        return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Empty KV cache (bf16 by default, as the reference's)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}

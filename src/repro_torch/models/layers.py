"""Shared layers: PimLinear, RMSNorm, LayerNorm, embedding, RoPE,
sinusoidal positions, the gated-SiLU and the GELU MLP (port of
``repro.models.layers``).

Weights keep the reference's ``(K, N)`` layout (``y = x @ w``) so a JAX
parameter tree converts leaf for leaf.  The execution context — backend
name, QuantState, plan and the A/D-op accumulator — travels explicitly in a
:class:`PimContext` instead of ambient state.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig, TRQConfig
from ..core.quant_state import active_quant_state
from ..core.trq import TRQParams, make_params
from ..dist.group import counts_here
from ..dist.sharding import carried
from ..pim.backend import get_backend, record_ad_ops, zero_ops
from ..pim.plan import run_prepared


def no_aux(device) -> torch.Tensor:
    """The aux loss of a model without MoE layers: 0.0 in f32."""
    return torch.zeros((), dtype=torch.float32, device=device)


def cdtype(cfg: ModelConfig) -> torch.dtype:
    """Compute dtype (activations)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def pdtype(cfg: ModelConfig) -> torch.dtype:
    """Parameter storage dtype."""
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def trq_params_from_cfg(t: TRQConfig) -> TRQParams:
    return make_params(delta_r1=t.delta_r1, bias=t.bias, n_r1=t.n_r1,
                       n_r2=t.n_r2, m=t.m, signed=t.signed)


_AMBIENT = object()


class PimContext:
    """One forward call's execution context: the backend name, the
    QuantState (when not given, the ambient ``use_quant_state`` one, as
    the reference's ``pim_linear`` reads it; an explicit ``None`` means
    none), the PimPlan, the CrossbarModel (noise-aware backends; None
    leaves them the ambient one) and the running A/D-op total (a 0-dim
    int64 tensor on the device, so metering never syncs the host).  Each
    call's ops also go to the per-layer census when one is open
    (``pim.backend.ad_ops_tally``).  While :meth:`muted` is entered (a
    rematerialised layer's recompute in backward) no ops are counted: a
    step counts each forward conversion once, as the reference's traced
    tally does."""

    def __init__(self, cfg: ModelConfig, backend: str,
                 quant_state=_AMBIENT, plan=None, device=None,
                 crossbar_model=None):
        self.cfg = cfg
        self.backend = backend
        self.quant_state = active_quant_state() \
            if quant_state is _AMBIENT else quant_state
        self.plan = plan
        self.crossbar_model = crossbar_model
        self.ops = zero_ops(device)
        self._muted = False

    def add_ops(self, ops: torch.Tensor, name: Optional[str] = None) -> None:
        if self._muted:
            return
        if counts_here():       # a replicated section counts on one rank
            self.ops = self.ops + ops
        record_ad_ops(name, ops)

    @contextlib.contextmanager
    def muted(self):
        prev, self._muted = self._muted, True
        try:
            yield self
        finally:
            self._muted = prev

    def remat_contexts(self):
        """``torch.utils.checkpoint``'s ``context_fn`` for a
        rematerialised layer: nothing around the forward; around the
        recompute, metering muted and the forward's mesh and row split
        reinstalled (:class:`~repro_torch.dist.sharding.carried`)."""
        state = carried()

        @contextlib.contextmanager
        def recompute():
            with state, self.muted():
                yield
        return contextlib.nullcontext(), recompute()


class PimLinear(nn.Module):
    """A weight-stationary linear on the PIM datapath.  ``name`` is the
    layer's QuantState name (``layer_0/attn/wq``); ``path`` its module
    path, which keys its plan."""

    def __init__(self, d_in: int, d_out: int, *, name: str,
                 bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.name = name
        self.path = name
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.empty(d_out, dtype=dtype, device=device),
                              requires_grad=False) if bias else None

    def forward(self, x: torch.Tensor, ctx: PimContext) -> torch.Tensor:
        return pim_linear(self, x, ctx)


def pim_linear(lin: PimLinear, x: torch.Tensor, ctx: PimContext,
               trq: Optional[TRQParams] = None) -> torch.Tensor:
    """x @ w on the context's backend.  Registers resolve in priority
    order: the explicit ``trq``, then the QuantState looked up by the
    layer's name, then the model-wide ``cfg.trq`` default with
    auto-ranging.  A plan programmed for the context's backend runs the
    prepared fast path instead (bitwise identical)."""
    cfg = ctx.cfg
    lp = ctx.plan.get(lin.path) if ctx.plan is not None else None
    if lp is not None and lp.backend == ctx.backend and trq is None:
        if tuple(lin.w.shape) != (lp.k, lp.n):
            raise ValueError(
                f"stale plan at {lin.name!r}: programmed for "
                f"({lp.k}, {lp.n}) but the weight is {tuple(lin.w.shape)}")
        out = run_prepared(x, lp, ste=True,
                           crossbar_model=ctx.crossbar_model)
    else:
        t = trq
        if t is None and ctx.quant_state is not None:
            t = ctx.quant_state.lookup(lin.name)
        auto_range = t is None and cfg.trq.auto_range
        if t is None:
            t = trq_params_from_cfg(cfg.trq)
        out = get_backend(ctx.backend)(
            x, lin.w.to(x.dtype), t.to(x.device), ste=True,
            auto_range=auto_range, delta_grid=cfg.trq.delta_grid,
            crossbar_model=ctx.crossbar_model)
    ctx.add_ops(out.ad_ops, lin.name)
    y = out.y
    if lin.b is not None:
        y = y + lin.b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norm / embedding / RoPE
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                              device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


NORM_CHUNK = 128      # the first stage of rmsnorm's sum on the card


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """On the card the mean square is summed in two fixed-width stages:
    CUDA's one-stage reduction splits the sum of a call with few rows
    across blocks, so a row's sum (and, an ulp later, a quantizer bin)
    would depend on how many rows its call holds, which a split sequence
    changes.  The CPU's is the row's own either way."""
    xf = x.float()
    sq = xf * xf
    d = x.shape[-1]
    if x.is_cuda and d % NORM_CHUNK == 0:
        ms = sq.unflatten(-1, (d // NORM_CHUNK, NORM_CHUNK)).sum(-1).sum(
            -1, keepdim=True) / d
    else:
        ms = torch.mean(sq, -1, keepdim=True)
    n = xf * torch.rsqrt(ms + eps)
    return (n * scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(d, **kw), requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x, eps)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """In f32 with the population variance, as the reference's."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, correction=0)
    return (((xf - mu) * torch.rsqrt(var + eps)) * scale + bias).to(x.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.tok = nn.Parameter(torch.empty(vocab, d, dtype=dtype,
                                            device=device),
                                requires_grad=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.tok, tokens)


def embed(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return tok[tokens]


def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    hd = cfg.hd
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Half-split rotation (the
    first and second halves of hd pair up), as the reference does."""
    ang = positions[..., None].float() * rope_freqs(cfg, x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoid_pos(seq: int, d: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(seq, d) sinusoidal table: sines of every position times the
    inverse frequencies, then cosines."""
    return sinusoid_at(torch.arange(seq, dtype=torch.float32,
                                    device=device), d).to(dtype)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at integer ``positions`` (any shape), f32.
    The frequencies' power is taken in f64 and rounded once to f32: the
    correctly rounded value, which XLA's f32 ``pow`` gives and torch's
    misses by an ulp on some exponents (an ulp of 1/10000^(i/d) moves the
    angle at position 1,499 by about 1e-4)."""
    expo = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    inv = 1.0 / (10000.0 ** expo.double()).float()
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# MLP (gated SiLU, or GELU whisper-style)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``mlp_act="silu"``: the gated-SiLU MLP; ``"gelu"``: up, GELU (tanh
    approximation, ``jax.nn.gelu``'s default), down.  ``bias`` gives every
    projection a bias."""

    def __init__(self, cfg: ModelConfig, prefix: str, dtype, device=None,
                 bias: bool = False):
        super().__init__()
        if cfg.mlp_act not in ("silu", "gelu"):
            raise NotImplementedError(f"mlp_act={cfg.mlp_act!r}")
        self.act = cfg.mlp_act
        kw = dict(dtype=dtype, device=device, bias=bias)
        if self.act == "silu":
            self.w_gate = PimLinear(cfg.d_model, cfg.d_ff,
                                    name=f"{prefix}/w_gate", **kw)
        self.w_up = PimLinear(cfg.d_model, cfg.d_ff, name=f"{prefix}/w_up",
                              **kw)
        self.w_down = PimLinear(cfg.d_ff, cfg.d_model,
                                name=f"{prefix}/w_down", **kw)

    def forward(self, x: torch.Tensor, ctx: PimContext) -> torch.Tensor:
        up = self.w_up(x, ctx)
        if self.act == "silu":
            gate = self.w_gate(x, ctx)
            h = gate * torch.sigmoid(gate) * up
        else:
            h = torch.nn.functional.gelu(up, approximate="tanh")
        return self.w_down(h, ctx)

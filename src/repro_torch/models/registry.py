"""Architecture registry: ``--arch <id>`` -> config, model and seeded init
(port of ``repro.models.registry``, every arch it holds: the dense
``llama3.2-3b``, ``deepseek-7b``, ``glm4-9b`` and ``deepseek-67b``, the
``internvl2-76b`` decoder with its patch frontend, ``rwkv6-7b``,
``whisper-medium``, ``granite-moe-3b-a800m``, ``arctic-480b`` and
``jamba-v0.1-52b``).

The reference's init draws from ``jax.random``, which PyTorch cannot
replay; :func:`init` draws from a ``torch.Generator`` with the same
distributions and scales (``init_linear``: N(0, 1) * d_in**-0.5;
``init_embed``: N(0, 1) * d_model**-0.5; biases 0; RMSNorm scales 1 and
LayerNorm scales 1 and biases 0, in f32; the
rwkv time-mix's leaves as ``repro.models.rwkv6.init_rwkv``; the MoE's as
``repro.models.moe.init_moe``: ``w_gate``/``w_up`` N(0, 1) * d**-0.5 and
``w_down`` N(0, 1) * d_ff**-0.5 in the parameter dtype, the router
N(0, 1) * d**-0.5 rounded through the parameter dtype and held in f32; the
mamba mixer's as ``repro.models.mamba.init_mamba``: ``conv_w`` N(0, 1) *
d_conv**-0.5 and ``dt_proj`` N(0, 1) * dt_rank**-0.5 in the parameter
dtype, ``dt_bias = log(expm1(exp(U(log 1e-3, log 1e-1))))``, ``a_log =
log(1..d_state)`` on every channel and ``d`` ones, in f32), on the
target device so a full-width model never passes through host memory.
Parity tests instead load the reference's own weights (``repro_torch.convert``).
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import Embed, LayerNorm, PimLinear, RMSNorm, pdtype
from .mamba import MambaMixer
from .moe import MoE
from .rwkv6 import HeadNormAffine, RWKV6TimeMix

ARCHS = ("jamba-v0.1-52b", "deepseek-67b", "deepseek-7b", "llama3.2-3b",
         "glm4-9b", "granite-moe-3b-a800m", "arctic-480b", "rwkv6-7b",
         "internvl2-76b", "whisper-medium")


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def list_archs():
    return ARCHS


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.smoke() if smoke else mod.CONFIG


def model_module(cfg: ModelConfig):
    """The module that holds ``cfg``'s model class and its cache
    functions (``init_cache``, ``init_state``, ``paged_keys``,
    ``STATIC_KEYS``): ``encdec`` for an encoder-decoder, else ``lm``."""
    from . import encdec, lm
    return encdec if cfg.encoder_layers > 0 else lm


def build_model(cfg: ModelConfig, device="meta"):
    """An ``EncDec`` (``cfg.encoder_layers > 0``) or an ``LM`` whose
    tensors are unallocated (``meta``) by default; load a state with
    ``load_state_dict(state, assign=True)``."""
    if cfg.encoder_layers > 0:
        from .encdec import EncDec
        return EncDec(cfg, device=device)
    from .lm import LM
    return LM(cfg, device=device)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded random weights as a state dict on ``device``: the card by
    default, as every entry point of the port (raises without one unless
    ``device="cpu"`` is given)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = pdtype(cfg)
    state = {}
    f32 = dict(dtype=torch.float32, device=device)
    for path, mod in build_model(cfg).named_modules():
        pre = f"{path}." if path else ""
        if isinstance(mod, PimLinear):
            d_in, d_out = mod.w.shape
            w = torch.randn(d_in, d_out, generator=gen, device=device)
            state[pre + "w"] = (w * d_in ** -0.5).to(dt)
            if mod.b is not None:
                state[pre + "b"] = torch.zeros(d_out, dtype=dt, device=device)
        elif isinstance(mod, RMSNorm):
            state[pre + "scale"] = torch.ones(mod.scale.shape[0],
                                              dtype=torch.float32,
                                              device=device)
        elif isinstance(mod, LayerNorm):
            state[pre + "scale"] = torch.ones(mod.scale.shape[0], **f32)
            state[pre + "bias"] = torch.zeros(mod.bias.shape[0], **f32)
        elif isinstance(mod, Embed):
            tok = torch.randn(*mod.tok.shape, generator=gen, device=device)
            state[pre + "tok"] = (tok * cfg.d_model ** -0.5).to(dt)
        elif isinstance(mod, RWKV6TimeMix):
            d, lora = mod.decay_lora_a.shape
            da = mod.decay_w.shape[0]
            state[pre + "mu"] = torch.full((5, d), 0.5, **f32)
            state[pre + "decay_w"] = torch.linspace(-6.0, -1.0, da, **f32)
            a = torch.randn(d, lora, generator=gen, device=device)
            state[pre + "decay_lora_a"] = (a * d ** -0.5).to(dt)
            state[pre + "decay_lora_b"] = torch.zeros(lora, da, dtype=dt,
                                                      device=device)
            state[pre + "bonus_u"] = torch.zeros(da, **f32)
        elif isinstance(mod, MoE):
            d, e = mod.router.w.shape
            f = mod.w_gate.shape[2]

            def normal(*shape, scale):
                x = torch.randn(*shape, generator=gen, device=device)
                return (x * scale).to(dt)
            state[pre + "router.w"] = normal(d, e, scale=d ** -0.5).float()
            state[pre + "w_gate"] = normal(e, d, f, scale=d ** -0.5)
            state[pre + "w_up"] = normal(e, d, f, scale=d ** -0.5)
            state[pre + "w_down"] = normal(e, f, d, scale=f ** -0.5)
        elif isinstance(mod, MambaMixer):
            dc, di = mod.conv_w.shape
            r, ds = mod.dt_proj.shape[0], mod.a_log.shape[1]
            conv = torch.randn(dc, di, generator=gen, device=device)
            state[pre + "conv_w"] = (conv * dc ** -0.5).to(dt)
            dtp = torch.randn(r, di, generator=gen, device=device)
            state[pre + "dt_proj"] = (dtp * r ** -0.5).to(dt)
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(di, generator=gen, device=device) * (hi - lo) + lo
            state[pre + "dt_bias"] = torch.log(torch.expm1(torch.exp(u)))
            # numpy's f32 log rounds log(7) as the reference's does
            # (torch's one ulp above)
            a_log = torch.from_numpy(np.log(np.arange(1, ds + 1,
                                                      dtype=np.float32)))
            state[pre + "a_log"] = a_log.to(device).expand(di, ds).clone()
            state[pre + "d"] = torch.ones(di, **f32)
        elif isinstance(mod, HeadNormAffine):
            state[pre + "scale"] = torch.ones(mod.scale.shape[0], **f32)
            state[pre + "bias"] = torch.zeros(mod.bias.shape[0], **f32)
    return state

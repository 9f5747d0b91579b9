"""Architecture registry: ``--arch <id>`` -> config, model and seeded init
(the ``llama3.2-3b``, ``rwkv6-7b`` and ``whisper-medium`` slice of
``repro.models.registry``).

The reference's init draws from ``jax.random``, which PyTorch cannot
replay; :func:`init` draws from a ``torch.Generator`` with the same
distributions and scales (``init_linear``: N(0, 1) * d_in**-0.5;
``init_embed``: N(0, 1) * d_model**-0.5; biases 0; RMSNorm scales 1 and
LayerNorm scales 1 and biases 0, in f32; the
rwkv time-mix's leaves as ``repro.models.rwkv6.init_rwkv``), on the
target device so a full-width model never passes through host memory.
Parity tests instead load the reference's own weights (``repro_torch.convert``).
"""
from __future__ import annotations

import importlib

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import Embed, LayerNorm, PimLinear, RMSNorm, pdtype
from .rwkv6 import HeadNormAffine, RWKV6TimeMix

ARCHS = ("llama3.2-3b", "rwkv6-7b", "whisper-medium")


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; ported: {ARCHS}")
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
        elif isinstance(mod, HeadNormAffine):
            state[pre + "scale"] = torch.ones(mod.scale.shape[0], **f32)
            state[pre + "bias"] = torch.zeros(mod.bias.shape[0], **f32)
    return state

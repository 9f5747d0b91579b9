"""Architecture registry: ``--arch <id>`` -> config, model and seeded init
(the ``llama3.2-3b`` slice of ``repro.models.registry``).

The reference's init draws from ``jax.random``, which PyTorch cannot
replay; :func:`init` draws from a ``torch.Generator`` with the same
distributions and scales (``init_linear``: N(0, 1) * d_in**-0.5;
``init_embed``: N(0, 1) * d_model**-0.5; RMSNorm scales 1, in f32), on the
target device so a full-width model never passes through host memory.
Parity tests instead load the reference's own weights (``repro_torch.convert``).
"""
from __future__ import annotations

import importlib

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import Embed, PimLinear, RMSNorm, pdtype

ARCHS = ("llama3.2-3b",)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.smoke() if smoke else mod.CONFIG


def build_model(cfg: ModelConfig, device="meta"):
    """An ``LM`` whose tensors are unallocated (``meta``) by default; load
    a state with ``load_state_dict(state, assign=True)``."""
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
        elif isinstance(mod, Embed):
            tok = torch.randn(*mod.tok.shape, generator=gen, device=device)
            state[pre + "tok"] = (tok * cfg.d_model ** -0.5).to(dt)
    return state

"""One explicit execution context: the ``Runtime`` object (port of
``repro.runtime.runtime``, single device, no mesh).

    rt = repro_torch.runtime.compile(cfg, state)       # device: cuda
    (logits, cache, _), report = rt.apply(batch)       # report.ad_ops

A ``Runtime`` owns the model on its device, the backend name, the
per-layer ``QuantState``, the weight-stationary ``PimPlan`` and the entry
points ``prefill`` / ``prefill_cont`` / ``decode`` / ``apply`` / ``mvm``,
each returning ``(out, AdOpsReport)``.  PyTorch runs eagerly, so there is
nothing to jit; every entry point runs under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..core.energy import adc_energy_pj
from ..core.quant_state import QuantState
from ..device import resolve_device
from ..models.layers import PimContext, pim_linear
from ..models.lm import LM, init_cache
from ..models.registry import build_model
from ..pim.backend import get_backend
from ..pim.plan import (PimPlan, check_plan, has_prepared, prepare_params,
                        quant_state_token)

_UNSET = object()


class AdOpsReport(NamedTuple):
    """The A/D-conversion accounting of one call: ``ad_ops`` is the summed
    SAR comparator-cycle count (Eq. 6), a 0-dim int64 device tensor."""

    ad_ops: torch.Tensor

    def total(self) -> float:
        return float(self.ad_ops)

    @property
    def ad_energy_pj(self) -> float:
        return adc_energy_pj(self.total())


class Runtime:
    """A compiled execution context (see module docstring).  Construct it
    through :func:`compile`."""

    def __init__(self, cfg: ModelConfig, model: LM, *, backend: str,
                 quant_state: Optional[QuantState], plan: Optional[PimPlan],
                 device: torch.device, plan_enabled: bool = True):
        self.cfg = cfg
        self.model = model
        self.backend = backend
        self.quant_state = quant_state
        self.plan = plan
        self.device = device
        self._plan_enabled = plan_enabled
        self.forward_calls = 0          # model forwards run by entry points

    def __repr__(self) -> str:
        return (f"Runtime({self.cfg.name}, backend={self.backend!r}, "
                f"plan={'yes' if self.plan is not None else 'no'}, "
                f"quant_state="
                f"{'yes' if self.quant_state is not None else 'no'}, "
                f"device={self.device})")

    def _ctx(self) -> PimContext:
        return PimContext(self.cfg, self.backend, self.quant_state,
                          self.plan, self.device)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(x, dtype=dtype, device=self.device)   # a copy

    def _forward(self, tokens, *, cache=None, mode: str, positions=None):
        ctx = self._ctx()
        with torch.no_grad():
            logits, new_cache = self.model(
                self._tensor(tokens), ctx, cache=cache, mode=mode,
                positions=None if positions is None
                else self._tensor(positions))
        self.forward_calls += 1
        return logits, new_cache, AdOpsReport(ctx.ops)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, device=self.device)

    # -- entry points (each returns (out, AdOpsReport)) ----------------------

    def apply(self, batch: dict, cache=None, mode: str = "train"):
        """The model forward: ``((logits, cache, aux), AdOpsReport)``;
        ``batch`` holds ``tokens`` and optionally ``positions``."""
        logits, new_cache, rep = self._forward(
            batch["tokens"], cache=cache, mode=mode,
            positions=batch.get("positions"))
        return (logits, new_cache, 0.0), rep

    def prefill(self, tokens, extra: Optional[dict] = None, *,
                max_len: int):
        """Prompt forward writing a fresh ``max_len``-deep cache:
        ``((last_logits, cache), AdOpsReport)``.  ``tokens``: (B, plen)."""
        if extra:
            raise NotImplementedError("modality inputs are not ported")
        cache = self.init_cache(len(tokens), max_len)
        logits, cache, rep = self._forward(tokens, cache=cache,
                                           mode="prefill")
        return (logits[:, -1], cache), rep

    def prefill_cont(self, tokens, positions, cache):
        """Continued prefill against a warm cache (prefix-reuse path)."""
        logits, cache, rep = self._forward(tokens, cache=cache,
                                           mode="prefill_cont",
                                           positions=positions)
        return (logits[:, -1], cache), rep

    def decode(self, tokens, cache, extra: Optional[dict] = None):
        """One token for every sequence in ``cache``."""
        if extra:
            raise NotImplementedError("modality inputs are not ported")
        logits, cache, rep = self._forward(tokens, cache=cache,
                                           mode="decode")
        return (logits[:, -1], cache), rep

    def mvm(self, x: torch.Tensor, layer: str):
        """Run ONE layer's MVM on the Runtime's datapath: ``(y,
        AdOpsReport)``.  ``layer`` is a QuantState-style name with an
        absolute depth (``layer_3/attn/wq``)."""
        parts = layer.split("/")
        if not parts[0].startswith("layer_"):
            raise KeyError(f"no layer {layer!r} in the model")
        path = ".".join(["layers", parts[0].split("_", 1)[1], *parts[1:]])
        try:
            lin = self.model.get_submodule(path)
        except AttributeError:
            raise KeyError(f"no layer {layer!r} in the model") from None
        ctx = self._ctx()
        with torch.no_grad():
            y = pim_linear(lin, x.to(self.device), ctx)
        return y, AdOpsReport(ctx.ops)

    # -- derivation ------------------------------------------------------------

    def with_overrides(self, *, backend: Optional[str] = None,
                       quant_state=_UNSET, plan=_UNSET) -> "Runtime":
        """A derived Runtime sharing the model; the plan is shared when its
        (backend, QuantState fingerprint) still matches, else it is
        re-programmed.  ``quant_state=None`` means "no registers"."""
        new_backend = backend or self.backend
        get_backend(new_backend)
        new_qs = self.quant_state if quant_state is _UNSET else quant_state
        if plan is _UNSET:
            plan_enabled = self._plan_enabled
            if (self.plan is not None and self.plan.backend == new_backend
                    and self.plan.qs_token == quant_state_token(new_qs)):
                built = check_plan(self.plan, self.model)
            else:
                built = _build_plan(self.cfg, self.model, new_backend,
                                    new_qs, plan_enabled)
        else:
            plan_enabled = plan is True or isinstance(plan, PimPlan)
            built = _build_plan(self.cfg, self.model, new_backend, new_qs,
                                plan)
        return Runtime(self.cfg, self.model, backend=new_backend,
                       quant_state=new_qs, plan=built, device=self.device,
                       plan_enabled=plan_enabled)


def _build_plan(cfg, model, backend: str, quant_state, plan):
    """``True`` programs a plan (None when the backend has no prepared
    path); a prebuilt ``PimPlan`` is validated; anything else is None."""
    if plan is True:
        if not has_prepared(backend):
            return None
        return prepare_params(model, cfg, quant_state=quant_state,
                              backend=backend)
    if isinstance(plan, PimPlan):
        if plan.backend != backend:
            raise ValueError(f"plan was programmed for backend "
                             f"{plan.backend!r} but the Runtime executes "
                             f"{backend!r}")
        if plan.qs_token != quant_state_token(quant_state):
            raise ValueError("plan was programmed against a different "
                             "QuantState than this Runtime executes")
        return check_plan(plan, model)
    return None


def compile(cfg: ModelConfig, params: Any, *, device=None,
            backend: Optional[str] = None,
            quant_state: Optional[QuantState] = None,
            plan: Any = True) -> Runtime:
    """Build a :class:`Runtime` on ``device`` (default ``cuda``; without a
    GPU, ``device="cpu"`` must be given).

    ``params`` is a state dict (from ``models.init`` or
    ``convert.from_jax``); its tensors move to the device.  ``backend``
    defaults to ``cfg.pim_backend``.  ``plan=True`` programs the
    weight-stationary plan, a prebuilt ``PimPlan`` is validated, and
    ``False``/``None`` serves dynamically.  TF32 is switched off: the
    reference's dots run at full f32 precision."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = backend or cfg.pim_backend
    get_backend(backend)
    model = build_model(cfg)
    model.load_state_dict({k: v.to(device) for k, v in params.items()},
                          assign=True)
    model.eval()
    plan_enabled = plan is True or isinstance(plan, PimPlan)
    built = _build_plan(cfg, model, backend, quant_state, plan)
    return Runtime(cfg, model, backend=backend, quant_state=quant_state,
                   plan=built, device=device, plan_enabled=plan_enabled)

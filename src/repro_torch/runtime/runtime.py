"""One explicit execution context: the ``Runtime`` object (port of
``repro.runtime.runtime``, single device, no mesh).

    rt = repro_torch.runtime.compile(cfg, state)       # device: cuda
    (logits, cache, _), report = rt.apply(batch)       # report.ad_ops

A ``Runtime`` owns the model on its device, the backend name, the
per-layer ``QuantState``, the ``CrossbarModel`` of the simulated device,
the weight-stationary ``PimPlan`` and the entry
points ``prefill`` / ``prefill_cont`` / ``decode`` / ``apply`` / ``mvm``,
each returning ``(out, AdOpsReport)``.  PyTorch runs eagerly, so there is
nothing to jit; every serving entry point runs under ``torch.no_grad``.

Training (``opt_init``, ``train_step``) runs on the differentiable
backends (``exact``, and ``fake_quant`` through its straight-through
estimator) with no plan, as the reference's train CLI compiles it; it
updates the model's parameters (``Runtime.params``) and the optimizer
state in place, as the reference's ``donate=True``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core.energy import adc_energy_pj
from ..core.quant_state import QuantState, save_quant_state
from ..device import resolve_device
from ..models.layers import PimContext, pim_linear
from ..models.registry import build_model, model_module
from ..pim.backend import get_backend
from ..pim.noise import (CrossbarModel, active_crossbar_model,
                         crossbar_token, is_noise_aware)
from ..pim.plan import (PimPlan, check_plan, has_prepared, prepare_params,
                        quant_state_token)

_UNSET = object()
# the backends with a gradient path (the reference's train CLI's choices:
# pallas and bit_exact have no VJP, noisy draws its faults once per plan)
TRAIN_BACKENDS = ("exact", "fake_quant")


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

    def __init__(self, cfg: ModelConfig, model, *, backend: str,
                 quant_state: Optional[QuantState], plan: Optional[PimPlan],
                 device: torch.device, plan_enabled: bool = True,
                 crossbar_model: Optional[CrossbarModel] = None,
                 tc: Optional[TrainConfig] = None):
        self.cfg = cfg
        self.model = model
        self.tc = tc
        self.params = dict(model.named_parameters())
        self._train = None              # (train_step, opt_init), built once
        self._step_ctx = None           # the PimContext of the running step
        self.backend = backend
        self.quant_state = quant_state
        self.plan = plan
        self.crossbar_model = crossbar_model
        self.device = device
        self._plan_enabled = plan_enabled
        self.forward_calls = 0          # forwards run by serving entry points

    def __repr__(self) -> str:
        return (f"Runtime({self.cfg.name}, backend={self.backend!r}, "
                f"plan={'yes' if self.plan is not None else 'no'}, "
                f"quant_state="
                f"{'yes' if self.quant_state is not None else 'no'}, "
                f"crossbar_model="
                f"{'yes' if self.crossbar_model is not None else 'no'}, "
                f"device={self.device})")

    def _ctx(self) -> PimContext:
        # the Runtime's device model wins over an ambient one, None included
        return PimContext(self.cfg, self.backend, self.quant_state,
                          self.plan, self.device,
                          self.crossbar_model or _IDEAL)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(x, dtype=dtype, device=self.device)   # a copy

    def _forward(self, tokens, *, cache=None, mode: str, positions=None,
                 extra: Optional[dict] = None):
        ctx = self._ctx()
        kw = {}
        if positions is not None:
            kw["positions"] = self._tensor(positions)
        if extra:
            if mode == "decode":
                raise ValueError(f"decode takes no modality inputs; got "
                                 f"{sorted(extra)}")
            if not (self.cfg.encoder_layers or self.cfg.frontend == "patch") \
                    or set(extra) != {"embeds"}:
                raise NotImplementedError(
                    f"{self.cfg.name}: modality inputs {sorted(extra)} are "
                    f"not ported (an encoder-decoder or a patch frontend "
                    f"takes 'embeds')")
            kw.update(self._modality(extra))
        with torch.no_grad():
            logits, new_cache, aux = self.model(self._tensor(tokens), ctx,
                                                cache=cache, mode=mode, **kw)
        self.forward_calls += 1
        return logits, new_cache, aux, AdOpsReport(ctx.ops)

    def _modality(self, extra: dict) -> dict:
        return {"embeds": self._tensor(extra["embeds"], torch.float32)} \
            if "embeds" in extra else {}

    def init_cache(self, batch: int, max_len: int) -> dict:
        """The model's own zeroed cache (an encoder-decoder's cross-KV is
        ``max_len`` rows deep, the reference's rule)."""
        return model_module(self.cfg).init_cache(self.cfg, batch, max_len,
                                                 device=self.device)

    # -- entry points (each returns (out, AdOpsReport)) ----------------------

    def apply(self, batch: dict, cache=None, mode: str = "train"):
        """The model forward: ``((logits, cache, aux), AdOpsReport)``;
        ``batch`` holds ``tokens`` and optionally ``positions`` (and,
        outside decode, an encoder-decoder's frames or a patch frontend's
        embeddings as ``embeds``)."""
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "positions")}
        logits, new_cache, aux, rep = self._forward(
            batch["tokens"], cache=cache, mode=mode,
            positions=batch.get("positions"), extra=extra)
        return (logits, new_cache, aux), rep

    def prefill(self, tokens, extra: Optional[dict] = None, *,
                max_len: int):
        """Prompt forward writing a fresh ``max_len``-deep cache:
        ``((last_logits, cache), AdOpsReport)``.  ``tokens``: (B, plen);
        an encoder-decoder takes its frames, a patch frontend its patch
        embeddings (cache rows before the prompt's) as ``extra={"embeds":
        (B, T, D)}``."""
        cache = self.init_cache(len(tokens), max_len)
        logits, cache, _, rep = self._forward(tokens, cache=cache,
                                              mode="prefill", extra=extra)
        return (logits[:, -1], cache), rep

    def prefill_cont(self, tokens, positions, cache):
        """Continued prefill against a warm cache (prefix-reuse path)."""
        logits, cache, _, rep = self._forward(tokens, cache=cache,
                                              mode="prefill_cont",
                                              positions=positions)
        return (logits[:, -1], cache), rep

    def decode(self, tokens, cache, extra: Optional[dict] = None):
        """One token for every sequence in ``cache``; ``extra`` must be
        empty (an encoder-decoder reads its cross-KV from the cache, a
        patch frontend's rows are in it)."""
        logits, cache, _, rep = self._forward(tokens, cache=cache,
                                              mode="decode", extra=extra)
        return (logits[:, -1], cache), rep

    def mvm(self, x: torch.Tensor, layer: str):
        """Run ONE layer's MVM on the Runtime's datapath: ``(y,
        AdOpsReport)``.  ``layer`` is a QuantState-style name: with an
        absolute depth (``layer_3/attn/wq``), or an encoder-decoder's
        (``enc/attn/wq``, ``dec/xattn/wk``, ``frontend/frame_proj``),
        whose stacked families resolve to depth 0 as in the reference, or
        a frontend's (``frontend/patch_proj``)."""
        parts = layer.split("/")
        if parts[0].startswith("layer_"):
            parts = ["layers", parts[0].split("_", 1)[1], *parts[1:]]
        elif parts[0] in ("enc", "dec") and self.cfg.encoder_layers > 0:
            parts = [parts[0], "0", *parts[1:]]
        elif parts[0] != "frontend" or self.cfg.frontend == "none":
            raise KeyError(f"no layer {layer!r} in the model")
        path = ".".join(parts)
        try:
            lin = self.model.get_submodule(path)
        except AttributeError:
            raise KeyError(f"no layer {layer!r} in the model") from None
        ctx = self._ctx()
        with torch.no_grad():
            y = pim_linear(lin, x.to(self.device), ctx)
        return y, AdOpsReport(ctx.ops)

    # -- training ---------------------------------------------------------------

    def _train_pair(self):
        """(train_step, opt_init) of the Runtime's ``TrainConfig``, built
        once; the parameters get gradients from here on."""
        if self._train is None:
            if self.backend not in TRAIN_BACKENDS:
                raise ValueError(
                    f"backend {self.backend!r} has no gradient path; train "
                    f"on one of {TRAIN_BACKENDS} (fake_quant is QAT through "
                    f"the straight-through estimator)")
            if self.plan is not None:
                raise ValueError("training updates the weights a plan "
                                 "freezes; compile with plan=None")
            from ..train.loop import make_train_step

            def apply_fn(batch):
                logits, _, aux = self.model(
                    batch["tokens"], self._step_ctx, mode="train",
                    **self._modality(batch))
                return logits, aux
            for p in self.params.values():
                p.requires_grad_(True)
            self._train = make_train_step(apply_fn, self.cfg,
                                          self.tc or TrainConfig())
        return self._train

    def opt_init(self, params: Optional[dict] = None) -> dict:
        """Optimizer state for the Runtime's ``TrainConfig``, in the
        reference's layout (``train.optimizer``)."""
        return self._train_pair()[1](self.params if params is None
                                     else params)

    def train_step(self, params: dict, opt_state: dict, batch: dict, step):
        """One optimizer step: ``((params, opt_state, metrics),
        AdOpsReport)``, ``metrics`` holding ``loss``, ``gnorm``, ``lr`` and
        ``ad_ops`` (each forward conversion counted once, rematerialised
        layers included).  ``params`` other than ``Runtime.params`` are
        copied into the model first; the model's parameters and
        ``opt_state`` are updated in place and returned.  ``batch`` holds
        ``tokens`` and ``labels`` (B, S) and, for an encoder-decoder, its frames
        as ``embeds``; a patch frontend's ``embeds`` raise ``ValueError``
        before any forward (its logits would have F + S rows)."""
        if self.cfg.frontend == "patch" and "embeds" in batch:
            raise ValueError(
                f"{self.cfg.name}: the patch rows prefix the sequence, so "
                f"the forward returns logits over F + S rows against S "
                f"labels; the reference's loss (src/repro/train/loop.py:"
                f"34-35) fails on the same batch")
        step_fn, _ = self._train_pair()
        if params is not self.params:
            with torch.no_grad():
                for name, live in self.params.items():
                    if params[name] is not live:
                        live.copy_(params[name])
        batch = {k: self._tensor(v, torch.float32 if k == "embeds"
                                 else torch.int32) for k, v in batch.items()}
        ctx = self._step_ctx = self._ctx()
        try:
            _, opt_state, metrics = step_fn(self.params, opt_state, batch,
                                            step)
        finally:
            self._step_ctx = None
        metrics["ad_ops"] = ctx.ops
        return (self.params, opt_state, metrics), AdOpsReport(ctx.ops)

    # -- derivation / persistence ---------------------------------------------

    def with_overrides(self, *, backend: Optional[str] = None,
                       quant_state=_UNSET, plan=_UNSET,
                       crossbar_model=_UNSET) -> "Runtime":
        """A derived Runtime sharing the model; the plan is shared when its
        (backend, QuantState fingerprint, CrossbarModel fingerprint) still
        matches, else it is re-programmed.  Overrides are literal:
        ``quant_state=None`` means "no registers", ``crossbar_model=None``
        "ideal device"."""
        new_backend = backend or self.backend
        get_backend(new_backend)
        new_qs = self.quant_state if quant_state is _UNSET else quant_state
        new_cm = self.crossbar_model if crossbar_model is _UNSET \
            else crossbar_model
        _check_model_backend(new_backend, new_cm)
        if plan is _UNSET:
            plan_enabled = self._plan_enabled
            if (self.plan is not None and self.plan.backend == new_backend
                    and self.plan.qs_token == quant_state_token(new_qs)
                    and self.plan.cm_token == crossbar_token(new_cm)):
                built = check_plan(self.plan, self.model)
            else:
                built = _build_plan(self.cfg, self.model, new_backend,
                                    new_qs, plan_enabled, new_cm)
        else:
            plan_enabled = plan is True or isinstance(plan, PimPlan)
            built = _build_plan(self.cfg, self.model, new_backend, new_qs,
                                plan, new_cm)
        return Runtime(self.cfg, self.model, backend=new_backend,
                       quant_state=new_qs, plan=built, device=self.device,
                       plan_enabled=plan_enabled, crossbar_model=new_cm,
                       tc=self.tc)

    def save(self, path: str) -> Optional[str]:
        """Snapshot the register file next to a checkpoint (the versioned
        ``quant_state.json`` both packages read); returns the written path,
        or None when the Runtime carries no QuantState."""
        if self.quant_state is None:
            return None
        return save_quant_state(path, self.quant_state)


_IDEAL = CrossbarModel()


def _check_model_backend(backend: str, crossbar_model) -> None:
    """A non-null CrossbarModel on a noise-blind backend would be silently
    ignored: every MVM would run ideal while the caller believes faults
    are injected.  Reject the combination."""
    if (crossbar_model is not None and not crossbar_model.is_null
            and not is_noise_aware(backend)):
        raise ValueError(
            f"crossbar_model carries non-idealities but backend "
            f"{backend!r} is not noise-aware (it would silently ignore "
            f"them); use backend='noisy' (or register_noise_aware)")


def _build_plan(cfg, model, backend: str, quant_state, plan,
                crossbar_model=None):
    """``True`` programs a plan (None when the backend has no prepared
    path); a prebuilt ``PimPlan`` is validated against the backend and the
    QuantState and CrossbarModel fingerprints; anything else is None."""
    if plan is True:
        if not has_prepared(backend):
            return None
        return prepare_params(model, cfg, quant_state=quant_state,
                              backend=backend, crossbar_model=crossbar_model)
    if isinstance(plan, PimPlan):
        if plan.backend != backend:
            raise ValueError(f"plan was programmed for backend "
                             f"{plan.backend!r} but the Runtime executes "
                             f"{backend!r}")
        if plan.qs_token != quant_state_token(quant_state):
            raise ValueError("plan was programmed against a different "
                             "QuantState than this Runtime executes")
        if plan.cm_token != crossbar_token(crossbar_model):
            raise ValueError("plan was programmed against a different "
                             "CrossbarModel (or fault seed) than this "
                             "Runtime executes")
        return check_plan(plan, model)
    return None


def compile(cfg: ModelConfig, params: Any, *, device=None,
            backend: Optional[str] = None,
            quant_state: Optional[QuantState] = None,
            plan: Any = True,
            crossbar_model: Optional[CrossbarModel] = None,
            tc: Optional[TrainConfig] = None) -> Runtime:
    """Build a :class:`Runtime` on ``device`` (default ``cuda``; without a
    GPU, ``device="cpu"`` must be given).

    ``params`` is a state dict (from ``models.init`` or
    ``convert.from_jax``); its tensors move to the device.  ``backend``
    defaults to ``cfg.pim_backend``.  ``plan=True`` programs the
    weight-stationary plan, a prebuilt ``PimPlan`` is validated, and
    ``False``/``None`` serves dynamically.  ``crossbar_model`` defaults to
    the ambient ``use_crossbar_model`` one; a non-null model on a
    noise-blind backend raises ``ValueError``.  ``tc`` is the training
    configuration of ``opt_init``/``train_step`` (default
    ``TrainConfig()``; train with ``plan=None``).  TF32 is switched off:
    the reference's dots run at full f32 precision."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = backend or cfg.pim_backend
    get_backend(backend)
    if crossbar_model is None:
        crossbar_model = active_crossbar_model()
    _check_model_backend(backend, crossbar_model)
    model = build_model(cfg)
    model.load_state_dict({k: v.to(device) for k, v in params.items()},
                          assign=True)
    model.eval()
    plan_enabled = plan is True or isinstance(plan, PimPlan)
    built = _build_plan(cfg, model, backend, quant_state, plan,
                        crossbar_model)
    return Runtime(cfg, model, backend=backend, quant_state=quant_state,
                   plan=built, device=device, plan_enabled=plan_enabled,
                   crossbar_model=crossbar_model, tc=tc)

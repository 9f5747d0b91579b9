"""Crossbar programming cache: weight-stationary PIM execution plans
(port of ``repro.pim.plan``; ``pim.noise`` adds the noisy backend's
recipe).

``prepare_params`` walks a model once — resolving each layer's SAR
registers through the same param-path names the QuantState rule table uses
— and emits a :class:`PimPlan` holding one :class:`LayerPlan` per
``PimLinear``.  Every backend's prepared fast path (``run_prepared``) is
bitwise identical to its dynamic call but touches only activations.

Plan fields: ``w_scale`` (frozen max-|w| half of the ADC grid), ``trq``
(resolved registers), ``w`` (exact and pallas: the compute-dtype weights,
the model's own tensor when it already has that dtype — the K1 kernel
streams bf16 weights and widens them in registers, and fits the auto-range
register in the same pass, so the plan holds no f32 image and no grouped
copy), ``w_g`` (fake_quant: grouped weights), ``w_mask`` (bit_exact: the
programmed cell planes, packed as ``xbar_mvm`` bit masks, 1 byte per
weight), ``w_colsum`` (bit_exact: the per-column sum of the int weights
for the offset correction) and ``w_analog``/``adc_off`` (noisy: the
faulted conductances and ADC offsets a non-null device bakes).  The
kernels mask ragged edges themselves, so nothing is padded.

Unlike the reference, the port's layers are not stacked along a period
axis: the plan is keyed by each ``PimLinear``'s module path
(``layers.3.attn.wq``), while registers resolve by its QuantState name,
which stays period-local under ``scan_layers=True`` (every layer of a
period-1 model is ``layer_0/...``) and per-depth otherwise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import torch

from ..core.quant_state import quant_state_to_dict
from ..core.trq import TRQParams
from .backend import (PimOut, _dynamic_scales, bit_exact_run,
                      bit_exact_weights, get_backend, grid_scale,
                      zero_ops)
from ..dist.group import cell_reducer
from .crossbar import (PimConfig, fake_quant_mvm_grouped, group_activations,
                       group_weights)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Frozen weight-side state of ONE planned linear."""

    w_scale: Optional[torch.Tensor] = None
    trq: Optional[TRQParams] = None
    w: Optional[torch.Tensor] = None        # exact / pallas
    w_g: Optional[torch.Tensor] = None      # fake_quant
    w_mask: Optional[torch.Tensor] = None   # bit_exact: (k_w, G, N, 4) int32
    w_colsum: Optional[torch.Tensor] = None  # bit_exact: (N,) f32
    w_analog: Optional[torch.Tensor] = None  # noisy: faulted conductances
    adc_off: Optional[torch.Tensor] = None   # noisy: fixed-pattern offsets
    backend: str = "exact"
    auto_range: bool = False
    delta_grid: float = 1.0
    k: int = 0
    n: int = 0
    pim: PimConfig = PimConfig()


@dataclasses.dataclass(frozen=True)
class PimPlan:
    """A whole model's programming cache: ``layers`` maps each PimLinear's
    module path to its LayerPlan.  ``qs_token`` fingerprints the QuantState
    the registers were resolved from, ``cm_token`` the device side of the
    CrossbarModel whose faults the plan bakes (``pim.noise``)."""

    layers: dict
    backend: str = "exact"
    qs_token: Optional[str] = None
    cm_token: Optional[str] = None

    def __len__(self) -> int:
        return len(self.layers)

    def get(self, path: str) -> Optional[LayerPlan]:
        return self.layers.get(path)


def quant_state_token(qs) -> Optional[str]:
    """Stable fingerprint of a QuantState's rule table (None for None);
    the same string the reference computes for the same rules."""
    if qs is None:
        return None
    blob = json.dumps(quant_state_to_dict(qs), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def prepare_linear(w: torch.Tensor, trq: Optional[TRQParams] = None, *,
                   backend: str = "exact", auto_range: bool = False,
                   delta_grid: float = 1.0, pim: PimConfig = PimConfig(),
                   dtype=None, crossbar_model=None) -> LayerPlan:
    """Program ONE (K, N) linear for ``backend``.  ``dtype`` is the compute
    dtype the layer will be called with: the frozen scale is computed on
    the weights cast to it, as the dynamic path does.  ``crossbar_model``
    reaches backends whose recipe bakes device-side faults
    (``@register_prepare_hook``)."""
    get_backend(backend)
    if w.ndim != 2:
        raise ValueError(f"prepare_linear wants (K, N), got {tuple(w.shape)}")
    k, n = int(w.shape[0]), int(w.shape[1])
    w_cast = w.to(dtype) if dtype is not None else w
    if trq is not None:
        trq = trq.to(w.device)
    kw = dict(trq=trq, backend=backend, auto_range=auto_range,
              delta_grid=float(delta_grid), k=k, n=n, pim=pim)
    if backend == "exact":
        return LayerPlan(w=w_cast, **kw)
    if backend in ("fake_quant", "pallas"):
        w_scale = torch.clamp_min(torch.amax(torch.abs(w_cast)),
                                  1e-6) / 127.0
        if backend == "fake_quant":
            return LayerPlan(w_scale=w_scale, w_g=group_weights(w_cast, pim),
                             **kw)
        from ..kernels.trq_group_mvm.ops import weight_operand
        return LayerPlan(w_scale=w_scale, w=weight_operand(w_cast), **kw)
    if backend == "bit_exact":
        w_scale, w_mask, w_colsum = bit_exact_weights(w_cast, pim)
        return LayerPlan(w_scale=w_scale, w_mask=w_mask, w_colsum=w_colsum,
                         **kw)
    hook = _PREPARE_HOOKS.get(backend)
    if hook is not None:
        return hook(w_cast, kw, crossbar_model)
    raise ValueError(f"backend {backend!r} has no prepared payload; serve "
                     f"it dynamically (plan=False)")


# programming recipes of non-stock backends: ``fn(w_cast, kw,
# crossbar_model) -> LayerPlan``, ``kw`` the common LayerPlan fields (the
# noisy recipe registers itself when ``pim.noise`` is imported)
_PREPARE_HOOKS: dict = {}


def register_prepare_hook(name: str):
    """Register the ``prepare_linear`` recipe of backend ``name``
    (decorator); pair it with ``@register_prepared``."""
    def _register(fn):
        _PREPARE_HOOKS[name] = fn
        return fn
    return _register


def has_prepared(backend: str) -> bool:
    return backend in _PREPARED


def iter_linears(model):
    """(module path, PimLinear) for every planned linear of a model."""
    from ..models.layers import PimLinear
    return [(path, mod) for path, mod in model.named_modules()
            if isinstance(mod, PimLinear)]


def prepare_params(model, cfg, quant_state=None,
                   backend: Optional[str] = None,
                   pim: PimConfig = PimConfig(), dtype=None,
                   crossbar_model=None) -> PimPlan:
    """Program every ``PimLinear`` of ``model`` for ``backend`` (default
    ``cfg.pim_backend``).  Registers resolve through ``quant_state`` by the
    layer's QuantState name; layers with no rule freeze the model-wide
    ``cfg.trq`` default and keep auto-ranging, as the dynamic path does.
    ``crossbar_model`` is the simulated device a noise-aware recipe bakes;
    its fingerprint rides the plan as ``cm_token``."""
    from ..models.layers import cdtype, pdtype, trq_params_from_cfg
    backend = backend or cfg.pim_backend
    # a decoder-only model's frontend runs before the compute-dtype cast,
    # on activations at the parameter dtype, so it is frozen at that dtype
    # (an encoder-decoder casts its frames first); ``dtype=`` overrides both
    front_dtype = dtype if dtype is not None else (
        cdtype(cfg) if cfg.encoder_layers else pdtype(cfg))
    dtype = dtype if dtype is not None else cdtype(cfg)
    default_trq = trq_params_from_cfg(cfg.trq)
    layers = {}
    with torch.no_grad():
        for path, lin in iter_linears(model):
            t = quant_state.lookup(lin.name) if quant_state is not None \
                else None
            auto = t is None and cfg.trq.auto_range
            layers[path] = prepare_linear(
                lin.w, t if t is not None else default_trq, backend=backend,
                auto_range=auto, delta_grid=cfg.trq.delta_grid, pim=pim,
                dtype=front_dtype if path.startswith("frontend.") else dtype,
                crossbar_model=crossbar_model)
    # duck-typed (any model exposing .plan_token()), so plan never imports
    # noise
    cm_token = None if crossbar_model is None else \
        crossbar_model.plan_token()
    return PimPlan(layers=layers, backend=backend,
                   qs_token=quant_state_token(quant_state),
                   cm_token=cm_token)


def check_plan(plan: PimPlan, model) -> PimPlan:
    """Stale-plan guard: every planned path must still name a PimLinear of
    the same (K, N) in ``model``."""
    lins = dict(iter_linears(model))
    for path, lp in plan.layers.items():
        lin = lins.get(path)
        if lin is None:
            raise ValueError(f"stale plan: no PimLinear at {path!r}")
        if tuple(lin.w.shape) != (lp.k, lp.n):
            raise ValueError(f"stale plan: {path!r} programmed for "
                             f"({lp.k}, {lp.n}) but the weight is "
                             f"{tuple(lin.w.shape)}")
    return plan


# ---------------------------------------------------------------------------
# prepared execution
# ---------------------------------------------------------------------------

_PREPARED: dict = {}


def register_prepared(name: str):
    def _register(fn):
        _PREPARED[name] = fn
        return fn
    return _register


def run_prepared(x: torch.Tensor, lp: LayerPlan,
                 backend: Optional[str] = None, **knobs) -> PimOut:
    """Execute ``x @ w`` against a programmed crossbar image."""
    if not isinstance(lp, LayerPlan):
        raise TypeError(f"plan= wants a LayerPlan, got {type(lp).__name__}")
    if backend is not None and backend != lp.backend:
        raise ValueError(f"plan was programmed for backend {lp.backend!r}, "
                         f"not {backend!r}")
    try:
        fn = _PREPARED[lp.backend]
    except KeyError:
        raise KeyError(f"no prepared path registered for backend "
                       f"{lp.backend!r}; known: {sorted(_PREPARED)}") \
            from None
    if x.shape[-1] != lp.k:
        raise ValueError(f"stale plan: programmed K={lp.k}, activations "
                         f"have K={x.shape[-1]}")
    return fn(x, lp, **knobs)


@register_prepared("exact")
def _prepared_exact(x, lp: LayerPlan, **_) -> PimOut:
    return PimOut(x @ lp.w.to(x.dtype), zero_ops(x.device))


@register_prepared("fake_quant")
def _prepared_fake_quant(x, lp: LayerPlan, *, a_scale=None, w_scale=None,
                         ste: bool = False, **_) -> PimOut:
    a_s, w_s = _dynamic_scales(x, None, a_scale,
                               w_scale if w_scale is not None
                               else lp.w_scale)
    grid = grid_scale(a_s, w_s, lp.delta_grid, x.device)
    y, ops = fake_quant_mvm_grouped(
        group_activations(x, lp.pim), lp.w_g.to(x.dtype), lp.trq, grid,
        x.dtype, ste=ste, auto_range=lp.auto_range, with_ops=True)
    return PimOut(y, ops)


@register_prepared("pallas")
def _prepared_pallas(x, lp: LayerPlan, *, a_scale=None, w_scale=None,
                     **_) -> PimOut:
    from ..kernels.trq_group_mvm import pack_scalars, trq_group_mvm_2d
    a_s, w_s = _dynamic_scales(x, None, a_scale,
                               w_scale if w_scale is not None
                               else lp.w_scale)
    grid = grid_scale(a_s, w_s, lp.delta_grid, x.device)
    trq = lp.trq
    y, ops = trq_group_mvm_2d(
        x.reshape(-1, lp.k).float().contiguous(), lp.w,
        pack_scalars(trq, grid, x.device), n_r1=trq.n_r1, n_r2=trq.n_r2,
        m=trq.m, nu=trq.nu, mode=trq.mode, auto_range=lp.auto_range,
        reduce_cells=cell_reducer())
    return PimOut(y.reshape(*x.shape[:-1], lp.n).to(x.dtype), ops)


@register_prepared("bit_exact")
def _prepared_bit_exact(x, lp: LayerPlan, *, a_scale=None, w_scale=None,
                        **_) -> PimOut:
    if w_scale is not None:
        raise ValueError(
            "bit_exact plans cannot take a per-call w_scale override: the "
            "programmed cell planes ARE a function of the weight scale; "
            "re-run prepare_linear/prepare_params (or call the dynamic "
            "backend) for a pinned grid")
    return bit_exact_run(x, lp.w_mask, lp.w_colsum, lp.w_scale, lp.trq,
                         lp.pim, lp.n, a_scale)

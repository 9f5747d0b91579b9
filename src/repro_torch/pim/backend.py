"""Unified PIM execution-backend API (port of ``repro.pim.backend``).

Every weight-stationary matmul routes through one contract:

    backend(x, w, trq, **knobs) -> PimOut(y, ad_ops)

``y`` is the (quantized) MVM result, ``ad_ops`` the total A/D operations
(SAR comparator cycles, Eq. 6) the conversions spent, as a 0-dim int64
tensor on ``x``'s device (the reference sums in f32, exact below 2^24; a
full-width prefill exceeds that).  Three backends ship in this slice:

``exact``       plain matmul, zero A/D operations.
``fake_quant``  per-128-row-group signed TRQ in plain tensor ops.
``pallas``      the fused ``trq_group_mvm`` kernel (the registry keeps the
                reference's name so configs and QuantStates that name
                ``pallas`` run unchanged): the CUDA kernel on the GPU, its
                plain version on the CPU.

The port passes the backend name explicitly (``Runtime`` owns it);
``use_backend`` remains for code that selects one ambiently.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..core.trq import TRQParams
from .crossbar import PimConfig, auto_range_fit, fake_quant_mvm


class PimOut(NamedTuple):
    """Uniform backend result: MVM output + total A/D operations."""
    y: torch.Tensor             # (..., N), x.dtype
    ad_ops: torch.Tensor        # 0-dim int64, SAR comparator cycles (Eq. 6)


_BACKENDS: dict = {}
_ACTIVE: dict = {"backend": None}


def register_backend(name: str, backend=None):
    """Register a datapath under ``name`` (also usable as a decorator)."""
    def _register(fn):
        _BACKENDS[name] = fn
        return fn
    return _register(backend) if backend is not None else _register


def get_backend(name: str):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown PIM backend {name!r}; registered: "
                       f"{sorted(_BACKENDS)}") from None


def list_backends() -> tuple:
    return tuple(sorted(_BACKENDS))


@contextlib.contextmanager
def use_backend(name: Optional[str]):
    """Select backend ``name`` for :func:`pim_mvm` calls without an explicit
    backend in the dynamic extent.  ``None`` is a no-op; a typo raises
    ``KeyError`` at once."""
    if name is not None:
        get_backend(name)
    prev = _ACTIVE["backend"]
    if name is not None:
        _ACTIVE["backend"] = name
    try:
        yield name
    finally:
        _ACTIVE["backend"] = prev


def active_backend() -> Optional[str]:
    return _ACTIVE["backend"]


def zero_ops(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _dynamic_scales(x, w, a_scale, w_scale, levels: float = 127.0):
    """Max-abs per-tensor scales (None -> dynamic) in the operand's dtype,
    as the reference computes them."""
    if a_scale is None:
        a_scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6) / levels
    if w_scale is None:
        w_scale = torch.clamp_min(torch.amax(torch.abs(w)), 1e-6) / levels
    return a_scale, w_scale


def grid_scale(a_s, w_s, delta_grid: float, device) -> torch.Tensor:
    """ADC integer grid: a_scale * w_scale * delta_grid, in f32."""
    return (torch.as_tensor(a_s, dtype=torch.float32, device=device)
            * torch.as_tensor(w_s, dtype=torch.float32, device=device)
            * delta_grid)


@register_backend("exact")
def exact_backend(x, w, trq=None, **_) -> PimOut:
    """Digital FP matmul: no crossbar, no conversion, zero A/D operations."""
    return PimOut(x @ w.to(x.dtype), zero_ops(x.device))


@register_backend("fake_quant")
def fake_quant_backend(x, w, trq, *, a_scale=None, w_scale=None,
                       delta_grid: float = 1.0, ste: bool = False,
                       auto_range: bool = False,
                       pim: PimConfig = PimConfig(), **_) -> PimOut:
    a_s, w_s = _dynamic_scales(x, w, a_scale, w_scale)
    grid = grid_scale(a_s, w_s, delta_grid, x.device)
    y, ops = fake_quant_mvm(x, w.to(x.dtype), trq, grid, 1.0, pim, ste=ste,
                            auto_range=auto_range, with_ops=True)
    return PimOut(y, ops)


@register_backend("pallas")
def pallas_backend(x, w, trq, *, a_scale=None, w_scale=None,
                   delta_grid: float = 1.0, auto_range: bool = False,
                   pim: PimConfig = PimConfig(), **_) -> PimOut:
    """Inference datapath through the ``trq_group_mvm`` kernel (not
    differentiable: train with ``fake_quant``)."""
    from ..kernels.trq_group_mvm import trq_group_mvm
    a_s, w_s = _dynamic_scales(x, w, a_scale, w_scale)
    grid = grid_scale(a_s, w_s, delta_grid, x.device)
    xf = x.float()
    wf = w.float()
    trq = trq.to(x.device)
    if auto_range:
        # the pre-fit runs outside the kernel, as in the reference
        trq = auto_range_fit(xf, wf, trq, grid, pim)
    y, ops = trq_group_mvm(xf, wf, trq, grid, 1.0, with_ops=True)
    return PimOut(y.to(x.dtype), ops)


def pim_mvm(x: torch.Tensor, w: Optional[torch.Tensor] = None,
            trq: Optional[TRQParams] = None,
            backend: Optional[str] = None, *, plan=None,
            **knobs) -> PimOut:
    """Run ``x @ w`` on a named datapath (default: the ambient
    ``use_backend`` selection, else ``exact``).  ``plan=<LayerPlan>`` runs
    the prepared fast path instead; ``w`` and ``trq`` must then be None."""
    if plan is not None:
        if w is not None or trq is not None:
            raise ValueError("pim_mvm(plan=...) carries the weight-side "
                             "state; pass w=None and trq=None")
        from .plan import run_prepared
        return run_prepared(x, plan, backend=backend, **knobs)
    name = backend or active_backend() or "exact"
    return get_backend(name)(x, w, trq, **knobs)

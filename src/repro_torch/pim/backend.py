"""Unified PIM execution-backend API (port of ``repro.pim.backend``).

Every weight-stationary matmul routes through one contract:

    backend(x, w, trq, **knobs) -> PimOut(y, ad_ops)

``y`` is the (quantized) MVM result, ``ad_ops`` the total A/D operations
(SAR comparator cycles, Eq. 6) the conversions spent, as a 0-dim int64
tensor on ``x``'s device (the reference sums in f32, exact below 2^24; a
full-width prefill exceeds that).  Four backends ship:

``exact``       plain matmul, zero A/D operations.
``fake_quant``  per-128-row-group signed TRQ in plain tensor ops.
``pallas``      the fused ``trq_group_mvm`` kernel (the registry keeps the
                reference's name so configs and QuantStates that name
                ``pallas`` run unchanged): the CUDA kernel on the GPU, its
                plain version on the CPU.
``bit_exact``   the full ISAAC sliced datapath (1-bit DAC slices x 1-bit
                cells, one conversion per bit-line) on PTQ-quantized
                inputs, through the ``xbar_mvm`` kernel on the GPU.

The port passes the backend name explicitly (``Runtime`` owns it);
``use_backend`` remains for code that selects one ambiently.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..core.trq import TRQParams
from .crossbar import PimConfig, fake_quant_mvm, offset_encode


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


# ---------------------------------------------------------------------------
# the per-layer A/D-operation census (opt-in; the default path never syncs)
# ---------------------------------------------------------------------------

class AdOpsTally:
    """Per-layer A/D operations of every ``pim_linear`` call made while the
    tally is open, keyed by the layer's QuantState name.  Values stay 0-dim
    int64 tensors on the device; :meth:`total` is the one host read.

    Unlike the reference, whose eager tally drops the values of jitted or
    scanned layers, the port runs eagerly and records every layer; under
    ``scan_layers=True`` the names are period-local, so a key sums its
    layer over the periods (``scan_layers=False`` gives one key per
    depth, the reference's census)."""

    def __init__(self):
        self.by_layer: dict = {}

    def add(self, name: str, ops: torch.Tensor) -> None:
        prev = self.by_layer.get(name)
        self.by_layer[name] = ops if prev is None else prev + ops

    def total(self) -> float:
        return float(sum(self.by_layer.values()))


_TALLY: list = []


@contextlib.contextmanager
def ad_ops_tally():
    """Collect every layer's A/D-operation count in the dynamic extent:
    ``with ad_ops_tally() as t: rt.prefill(...); t.by_layer``."""
    t = AdOpsTally()
    _TALLY.append(t)
    try:
        yield t
    finally:
        _TALLY.remove(t)


def record_ad_ops(name: Optional[str], ops: torch.Tensor) -> None:
    """Add one call's ops to the innermost open tally; with none open this
    is a list test and nothing else (no tensor op, no host sync)."""
    if _TALLY:
        _TALLY[-1].add(name or "<unnamed>", ops)


def zero_ops(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _stable_recip(s) -> torch.Tensor:
    """1/s rounded to bf16 and widened back to f32: the reference's
    determinism barrier, kept so the PTQ integers equal its own."""
    s = torch.as_tensor(s, dtype=torch.float32)
    return (1.0 / s).to(torch.bfloat16).float()


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
                   **_) -> PimOut:
    """Inference datapath through the ``trq_group_mvm`` kernel (not
    differentiable: train with ``fake_quant``).  The kernel reads ``w`` as
    given (bf16 or f32) and, with ``auto_range``, fits ``delta_r1`` to its
    own partial sums: one read of the weights per call."""
    from ..kernels.trq_group_mvm import trq_group_mvm
    a_s, w_s = _dynamic_scales(x, w, a_scale, w_scale)
    grid = grid_scale(a_s, w_s, delta_grid, x.device)
    y, ops = trq_group_mvm(x, w, trq.to(x.device), grid, 1.0, with_ops=True,
                           auto_range=auto_range)
    return PimOut(y.to(x.dtype), ops)


def ptq_scale(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Max-abs symmetric scale of an f32 tensor for ``bits``-bit ints,
    a multiply by the reciprocal constant (the reference's chain)."""
    return torch.clamp_min(torch.amax(torch.abs(t)), 1e-6) * \
        (1.0 / (2 ** (bits - 1) - 1))


def ptq_int(t: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """f32 tensor -> int32 in [-2^(bits-1), 2^(bits-1)): floor(t/s + 0.5)
    through the ``_stable_recip`` barrier, clipped."""
    half = 2 ** (bits - 1)
    r = _stable_recip(scale).to(t.device)
    return torch.clamp(torch.floor(t * r + 0.5), -half, half - 1).to(
        torch.int32)


def bit_exact_weights(w: torch.Tensor, pim: PimConfig, w_scale=None):
    """The programming pass of a (K, N) weight: ``(w_scale, w_mask,
    w_colsum)`` — the frozen scale, the offset-encoded cell planes packed
    as ``xbar_mvm`` bit masks, and the per-column sum of the int weights
    for the digital offset correction."""
    from ..kernels.xbar_mvm import pack_weight_planes
    wf = w.float()
    w_s = ptq_scale(wf, pim.k_w) if w_scale is None else \
        torch.as_tensor(w_scale, dtype=torch.float32, device=w.device)
    w_int = ptq_int(wf, w_s, pim.k_w)
    u, _ = offset_encode(w_int, pim.k_w)
    return w_s, pack_weight_planes(u, pim.k_w), w_int.float().sum(0)


def bit_exact_run(x: torch.Tensor, w_mask: torch.Tensor,
                  w_colsum: torch.Tensor, w_s, trq: Optional[TRQParams],
                  pim: PimConfig, n: int, a_scale=None) -> PimOut:
    """The context-stable PTQ chain of the reference's ``bit_exact``
    backend and prepared path (one function here): f32 activations,
    reciprocal-multiply scale, ``a_u = a_int + 2^(k_i-1)`` through the
    sliced crossbar, then the correction ``half_a * colsum(w_int)`` and the
    rescale.  ``trq`` acts on the raw bit-line grid; None is lossless."""
    from ..kernels.xbar_mvm import xbar_mvm_packed
    half_a = 2 ** (pim.k_i - 1)
    x2 = x.reshape(-1, x.shape[-1]).float()
    a_s = ptq_scale(x2, pim.k_i) if a_scale is None else \
        torch.as_tensor(a_scale, dtype=torch.float32, device=x.device)
    a_u = ptq_int(x2, a_s, pim.k_i) + half_a
    out, ops = xbar_mvm_packed(a_u, w_mask, trq, k_i=pim.k_i, k_w=pim.k_w,
                               r_adc=pim.r_adc)
    return PimOut(ptq_rescale(out, x, a_s, w_s, w_colsum, half_a, n), ops)


def ptq_rescale(out: torch.Tensor, x: torch.Tensor, a_s, w_s,
                w_colsum: torch.Tensor, half_a: int, n: int) -> torch.Tensor:
    """The crossbar's (M, N) integer result -> ``x.dtype`` outputs: the
    activation offset correction ``half_a * colsum(w_int)``, then the PTQ
    rescale ``a_s * w_s``."""
    y = (out - half_a * w_colsum) * (a_s * torch.as_tensor(
        w_s, dtype=torch.float32, device=x.device))
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


@register_backend("bit_exact")
def bit_exact_backend(x, w, trq, *, a_scale=None, w_scale=None,
                      pim: PimConfig = PimConfig(), **_) -> PimOut:
    """Full sliced-datapath audit through the ``xbar_mvm`` kernel:
    activations and weights PTQ-quantized to k_i/k_w-bit ints (max-abs,
    symmetric), every bit-line partial sum converted by the (TRQ-)ADC.
    ``trq`` acts on the raw bit-line grid ([0, xbar] sums: registers that
    Algorithm 1 calibrated on ``collect_bl_samples``); ``trq=None`` is the
    lossless datapath; ``auto_range`` and ``delta_grid`` do not apply."""
    w_s, w_mask, w_colsum = bit_exact_weights(w, pim, w_scale)
    return bit_exact_run(x, w_mask, w_colsum, w_s, trq, pim, w.shape[1],
                         a_scale)


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

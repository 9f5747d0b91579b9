"""Device non-ideality modeling: the ``CrossbarModel`` seam and the ``noisy``
backend (port of ``repro.pim.noise``).

Real ReRAM arrays are not ideal: conductances land off-target when
programmed, a fraction of cells is stuck at G_min/G_max (SA0/SA1), bit-line
currents fluctuate per read, long columns droop under IR-drop, and the SAR
ADC adds a fixed-pattern offset and thermal noise.  :class:`CrossbarModel`
packages those knobs, every field optional and independently zeroable, and
the ``noisy`` backend threads them through ``bit_exact``'s sliced bit-line
datapath, returning the same ``PimOut(y, ad_ops)``.

Two fault families, two sampling times (as in the hardware):

* **Device-side** (``g_sigma``, ``sa0``, ``sa1``, ``adc_offset``): frozen at
  programming time.  Draws come from a ``torch.Generator`` seeded by the
  fault seed and a content hash of the programmed integer weights, so the
  dynamic path and a ``prepare_params``-baked plan (``LayerPlan.w_analog`` /
  ``adc_off``) sample the same device bit for bit, and distinct layers get
  independent faults.
* **Call-side** (``read_sigma``, ``adc_sigma``; ``ir_drop`` is
  deterministic): drawn per call from a generator seeded by ``key`` (or the
  fault seed) and a content hash of the partial sums: same key and inputs,
  same draws.

The reference draws with threefry ``fold_in``, which torch cannot replay:
the two packages sample the same distributions, not the same values.  Each
hash is one host read, paid only on a path that draws.

Zero is exact: a field left at a Python ``0.0`` contributes nothing, and a
missing or all-zeros model routes straight through ``bit_exact`` (so the
``xbar_mvm`` kernel on the card), bitwise identical to it (y and ad_ops).
A field given as a tensor is never statically zero: reading it would sync
the host.  It takes the full analog datapath, which a zero tensor
perturbs by exactly +0.0 / *1.0 (the reference's traced zeros).

The noisy plan bakes f32 analog planes, 32 bytes a weight (the reference's
layout): a non-null model fits the card at the smoke config and at single
full-width layers, not at a full-width model (about 90 GB for
llama3.2-3b).  A device-null model keeps the packed 1-byte cell masks of
``bit_exact``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from typing import Optional

import torch

from ..core.trq import TRQParams, trq_ad_ops, trq_quant
from .backend import (PimOut, bit_exact_backend, bit_exact_run,
                      bit_exact_weights, ptq_int, ptq_rescale, ptq_scale,
                      register_backend)
from .crossbar import PimConfig, _group, _shift_add, bitplanes, weight_planes
from .plan import LayerPlan, register_prepare_hook, register_prepared


def _static_zero(v) -> bool:
    """True when ``v`` is statically zero: None or a Python/numpy zero.  A
    tensor never is (see the module docstring)."""
    if v is None:
        return True
    if isinstance(v, torch.Tensor):
        return False
    return float(v) == 0.0


@dataclasses.dataclass(frozen=True)
class CrossbarModel:
    """One crossbar's non-ideality budget; every field defaults to the
    ideal device.  Rates and sigmas are in the datapath's natural units:
    conductances are 0/1 cell values, partial sums live on the ``[0,
    xbar]`` bit-line integer grid the ADC samples."""

    g_sigma: object = 0.0     # relative conductance-programming std
    sa0: object = 0.0         # stuck-at-0 (G_min) cell fault rate
    sa1: object = 0.0         # stuck-at-1 (G_max) cell fault rate
    read_sigma: object = 0.0  # per-read bit-line current noise std (LSB)
    ir_drop: object = 0.0     # per-column droop coefficient: p*(1-c*p/xbar)
    adc_offset: object = 0.0  # fixed-pattern per-bit-line ADC offset std
    adc_sigma: object = 0.0   # ADC thermal (input-referred) std
    seed: int = 0             # device/fault seed (non-negative)
    key: Optional[int] = None  # per-call seed (None: derived from seed)

    _DEVICE_FIELDS = ("g_sigma", "sa0", "sa1", "adc_offset")
    _CALL_FIELDS = ("read_sigma", "ir_drop", "adc_sigma")

    @property
    def device_null(self) -> bool:
        """No programming-time faults: a plan keeps the ideal cells."""
        return all(_static_zero(getattr(self, f))
                   for f in self._DEVICE_FIELDS)

    @property
    def call_null(self) -> bool:
        return all(_static_zero(getattr(self, f)) for f in self._CALL_FIELDS)

    @property
    def is_null(self) -> bool:
        """Statically ideal: the noisy backend shortcuts to bit_exact."""
        return self.device_null and self.call_null

    def replace(self, **kw) -> "CrossbarModel":
        return dataclasses.replace(self, **kw)

    def plan_token(self) -> Optional[str]:
        """Fingerprint of the device side (fault seed and programming-time
        field values), stamped into ``PimPlan.cm_token`` so a plan baked
        for one device is rejected against another.  None for a
        device-ideal model: call-side noise never invalidates a plan."""
        if self.device_null:
            return None
        vals = {f: float(getattr(self, f)) for f in self._DEVICE_FIELDS}
        vals["seed"] = int(self.seed)
        blob = json.dumps(vals, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def crossbar_token(model: Optional[CrossbarModel]) -> Optional[str]:
    """``model.plan_token()``, None-propagating."""
    return None if model is None else model.plan_token()


# backends that consume a CrossbarModel; Runtime rejects a non-null model
# on any other backend, which would silently ignore it
_NOISE_AWARE: set = {"noisy"}


def register_noise_aware(name: str) -> None:
    """Declare that backend ``name`` consumes the CrossbarModel."""
    _NOISE_AWARE.add(name)


def is_noise_aware(name: str) -> bool:
    return name in _NOISE_AWARE


_ACTIVE: dict = {"cm": None}


@contextlib.contextmanager
def use_crossbar_model(model: Optional[CrossbarModel]):
    """Install ``model`` for noise-aware calls in the dynamic extent that
    are given none explicitly.  ``None`` is a no-op.  Nestable."""
    prev = _ACTIVE["cm"]
    if model is not None:
        _ACTIVE["cm"] = model
    try:
        yield model
    finally:
        _ACTIVE["cm"] = prev


def active_crossbar_model() -> Optional[CrossbarModel]:
    return _ACTIVE["cm"]


# ---------------------------------------------------------------------------
# seeded draws (device side: a pure function of (seed, programmed weights))
# ---------------------------------------------------------------------------

def value_salt(t: torch.Tensor) -> int:
    """Deterministic 32-bit content hash of a tensor, position-mixed: an
    integer sum of the f32 bit patterns, so it is independent of the
    reduction order.  One host read."""
    u = t.reshape(-1).float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    wgt = torch.arange(u.numel(), dtype=torch.int64, device=t.device) \
        % 65521 + 1
    # 16-bit halves keep every partial sum below 2^63
    lo, hi = torch.stack([((u & 0xFFFF) * wgt).sum(),
                          ((u >> 16) * wgt).sum()]).tolist()
    return (lo * 65537 + hi) & 0xFFFFFFFF


def _generator(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded by a hash of ``parts``."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _call_seed(model: CrossbarModel):
    return ("key", int(model.key)) if model.key is not None else \
        ("seed", int(model.seed))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _normal(shape, gen, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def perturb_planes(planes: torch.Tensor, model: CrossbarModel,
                   salt: int) -> torch.Tensor:
    """0/1 cell planes -> f32 analog conductances with programming
    variation and stuck-at faults, a pure function of (seed, salt)."""
    g = planes.float()
    if model.device_null:
        return g
    dev = g.device
    if not _static_zero(model.g_sigma):
        eta = _normal(g.shape, _generator(dev, "g_sigma", int(model.seed),
                                          salt), dev)
        g = g * (1.0 + _f32(model.g_sigma, dev) * eta)
    if not (_static_zero(model.sa0) and _static_zero(model.sa1)):
        # one uniform field decides both fault kinds (disjoint tails,
        # sa0 + sa1 <= 1): SA0 pins the cell to G_min, SA1 to G_max
        u = torch.rand(g.shape, generator=_generator(
            dev, "sa", int(model.seed), salt), dtype=torch.float32,
            device=dev)
        g = torch.where(u < _f32(model.sa0, dev), 0.0, g)
        g = torch.where(u >= 1.0 - _f32(model.sa1, dev), 1.0, g)
    return g


def adc_offsets(model: CrossbarModel, salt: int, shape,
                device) -> Optional[torch.Tensor]:
    """Fixed-pattern per-(weight plane, group, bit-line) ADC offsets,
    device-side, so they bake into plans.  ``shape``: (k_w, G, N)."""
    if _static_zero(model.adc_offset):
        return None
    gen = _generator(device, "adc_offset", int(model.seed), salt)
    return _f32(model.adc_offset, device) * _normal(shape, gen, device)


# ---------------------------------------------------------------------------
# the perturbed bit-line datapath
# ---------------------------------------------------------------------------

def perturb_psums(p: torch.Tensor, model: CrossbarModel, cfg: PimConfig,
                  adc_off: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Call-side physics on the (k_i, k_w, G, M, N) analog partial sums, in
    signal order: IR-drop compression, read noise, ADC fixed-pattern
    offset, ADC thermal noise.  Statically zero fields cost nothing."""
    dev = p.device
    if not _static_zero(model.ir_drop):
        p = p * (1.0 - _f32(model.ir_drop, dev) * p * (1.0 / float(cfg.xbar)))
    read = not _static_zero(model.read_sigma)
    therm = not _static_zero(model.adc_sigma)
    salt = value_salt(p) if read or therm else 0
    if read:
        gen = _generator(dev, "read", _call_seed(model), salt)
        p = p + _f32(model.read_sigma, dev) * _normal(p.shape, gen, dev)
    if adc_off is not None:
        p = p + adc_off[None, :, :, None, :]
    if therm:
        gen = _generator(dev, "therm", _call_seed(model), salt)
        p = p + _f32(model.adc_sigma, dev) * _normal(p.shape, gen, dev)
    return p


def noisy_bl_mvm(a_uint: torch.Tensor, analog_planes: torch.Tensor,
                 trq: Optional[TRQParams], model: CrossbarModel,
                 cfg: PimConfig, adc_off: Optional[torch.Tensor] = None):
    """``bit_exact_mvm``'s bit-line datapath on analog (possibly faulted,
    f32) (k_w, G, X, N) cell planes, with call-side noise on the partial
    sums before the (TRQ-)ADC.  Returns (integer-valued f32 out, total
    ad_ops int64).  With ``trq=None`` the native R_ADC still digitizes:
    round and clip to ``[0, xbar]``, a no-op on ideal sums."""
    a_g = _group(bitplanes(a_uint, cfg.k_i), cfg.xbar, 2)       # (k_i,M,G,X)
    p = torch.einsum("imgx,jgxn->ijgmn", a_g.float(),
                     analog_planes.float())                     # (k_i,k_w,G,M,N)
    p = perturb_psums(p, model, cfg, adc_off)
    if trq is None:
        y_q = torch.clamp(torch.floor(p + 0.5), 0.0, float(cfg.xbar))
        ops = torch.full((), cfg.r_adc * p.numel(), dtype=torch.int64,
                         device=p.device)
    else:
        trq = trq.to(p.device)
        y_q = trq_quant(p, trq)
        ops = trq_ad_ops(p, trq).sum(dtype=torch.int64)
    acc = _shift_add(y_q, cfg)
    zp = 2 ** (cfg.k_w - 1)
    return acc - zp * a_uint.float().sum(1, keepdim=True), ops


def _resolve(crossbar_model: Optional[CrossbarModel]):
    return crossbar_model if crossbar_model is not None \
        else active_crossbar_model()


# ---------------------------------------------------------------------------
# the `noisy` backend (dynamic and prepared paths)
# ---------------------------------------------------------------------------

@register_backend("noisy")
def noisy_backend(x, w, trq, *, a_scale=None, w_scale=None,
                  pim: PimConfig = PimConfig(),
                  crossbar_model: Optional[CrossbarModel] = None,
                  **knobs) -> PimOut:
    """``bit_exact`` under a :class:`CrossbarModel` (the explicit argument,
    else the ambient ``use_crossbar_model`` one).  A missing or statically
    null model routes straight through ``bit_exact_backend``."""
    model = _resolve(crossbar_model)
    if model is None or model.is_null:
        return bit_exact_backend(x, w, trq, a_scale=a_scale,
                                 w_scale=w_scale, pim=pim, **knobs)
    half_a = 2 ** (pim.k_i - 1)
    x2 = x.reshape(-1, x.shape[-1]).float()
    wf = w.float()
    a_s = ptq_scale(x2, pim.k_i) if a_scale is None else _f32(a_scale,
                                                              x.device)
    w_s = ptq_scale(wf, pim.k_w) if w_scale is None else _f32(w_scale,
                                                              x.device)
    w_int = ptq_int(wf, w_s, pim.k_w)
    salt = value_salt(w_int)
    planes = weight_planes(w_int, pim)                  # (k_w, G, X, N)
    analog = perturb_planes(planes, model, salt)
    adc_off = adc_offsets(model, salt, planes.shape[:2] + planes.shape[3:],
                          x.device)
    out, ops = noisy_bl_mvm(ptq_int(x2, a_s, pim.k_i) + half_a, analog, trq,
                            model, pim, adc_off)
    # the offset correction uses the intended weights: the S+A logic
    # subtracts the zero-point, it is not read from the array
    return PimOut(ptq_rescale(out, x, a_s, w_s, w_int.float().sum(0),
                              half_a, w.shape[1]), ops)


@register_prepare_hook("noisy")
def _prepare_noisy(w_cast: torch.Tensor, kw: dict,
                   model: Optional[CrossbarModel]) -> LayerPlan:
    """Programming pass: the bit_exact PTQ chain, then the device-side
    faults baked into f32 analog planes (``w_analog``) and fixed-pattern
    ADC offsets (``adc_off``).  A device-null model keeps bit_exact's
    packed cell masks."""
    pim = kw["pim"]
    w_scale, w_mask, w_colsum = bit_exact_weights(w_cast, pim)
    base = dict(w_scale=w_scale, w_colsum=w_colsum, **kw)
    if model is None or model.device_null:
        return LayerPlan(w_mask=w_mask, **base)
    w_int = ptq_int(w_cast.float(), w_scale, pim.k_w)
    salt = value_salt(w_int)
    planes = weight_planes(w_int, pim)
    return LayerPlan(
        w_analog=perturb_planes(planes, model, salt),
        adc_off=adc_offsets(model, salt, planes.shape[:2] + planes.shape[3:],
                            w_cast.device), **base)


@register_prepared("noisy")
def _prepared_noisy(x, lp: LayerPlan, *, a_scale=None, w_scale=None,
                    crossbar_model: Optional[CrossbarModel] = None,
                    **_) -> PimOut:
    """Prepared fast path: device faults come baked in the plan; only
    call-side noise (explicit or ambient model) is drawn here.  Bitwise
    identical to the dynamic call for the same model; ideal cells with no
    call-side noise run bit_exact's prepared path."""
    if w_scale is not None:
        raise ValueError(
            "noisy plans cannot take a per-call w_scale override: the "
            "programmed cell planes ARE a function of the weight scale; "
            "re-run prepare_linear/prepare_params (or call the dynamic "
            "backend) for a pinned grid")
    model = _resolve(crossbar_model) or CrossbarModel()
    pim = lp.pim
    if lp.w_analog is None and model.call_null:
        return bit_exact_run(x, lp.w_mask, lp.w_colsum, lp.w_scale, lp.trq,
                             pim, lp.n, a_scale)
    if lp.w_analog is not None:
        planes = lp.w_analog
    else:
        from ..kernels.xbar_mvm.ref import unpack_planes
        planes = unpack_planes(lp.w_mask).transpose(2, 3)
    half_a = 2 ** (pim.k_i - 1)
    x2 = x.reshape(-1, lp.k).float()
    a_s = ptq_scale(x2, pim.k_i) if a_scale is None else _f32(a_scale,
                                                              x.device)
    out, ops = noisy_bl_mvm(ptq_int(x2, a_s, pim.k_i) + half_a, planes,
                            lp.trq, model, pim, lp.adc_off)
    return PimOut(ptq_rescale(out, x, a_s, lp.w_scale, lp.w_colsum, half_a,
                              lp.n), ops)

"""Twin-Range Quantization (TRQ) — the paper's Eq. 1 / Eq. 7 / Eq. 8.

Port of ``repro.core.trq``.  The quantizer is the behavioral abstraction of
the SAR-ADC's A/D conversion at the crossbar bit-lines (paper §III-B).

Conventions (unchanged from the reference):

* ``delta_r1`` is the fine step; ``delta_r2 = 2**m * delta_r1`` (Eq. 8).
* R1 = ``[offset, offset + 2**n_r1 * delta_r1)`` with ``offset =
  bias * 2**n_r1 * delta_r1``.
* A value outside R1 is quantized as ``Q_{n_r2}(x, delta_r2)``.
* ``n_r1``/``n_r2``/``m``/``nu``/``mode``/``signed`` are static Python
  values; ``delta_r1``/``bias`` are 0-dim float32 tensors that may live on
  the GPU (the auto-range fit produces them there every call).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TRQParams:
    """Configuration registers of the modified SAR ADC (paper §III-D-2c)."""

    delta_r1: torch.Tensor      # fine step, 0-dim f32
    bias: torch.Tensor          # integer in [0, 2**m - 1], stored as f32
    n_r1: int = 4
    n_r2: int = 4
    m: int = 3
    nu: int = 1
    # 'twin' = TRQ mode, 'uniform' = plain N_R2-bit uniform ADC
    mode: str = "twin"
    # signed extension: quantize sign(x) * T(|x|)
    signed: bool = False

    @property
    def delta_r2(self) -> torch.Tensor:
        return self.delta_r1 * (2.0 ** self.m)

    @property
    def theta(self) -> torch.Tensor:
        """Upper edge of R1 (range-detect threshold)."""
        return self.offset + (2.0 ** self.n_r1) * self.delta_r1

    @property
    def offset(self) -> torch.Tensor:
        return self.bias * (2.0 ** self.n_r1) * self.delta_r1

    def replace(self, **kw) -> "TRQParams":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "TRQParams":
        return self.replace(delta_r1=self.delta_r1.to(device),
                            bias=self.bias.to(device))


def register_scalars(p: TRQParams, device) -> torch.Tensor:
    """[delta_r1, bias] as one f32 tensor on ``device``: the register
    operand the kernels read through a device pointer (no host sync when
    the registers already live there)."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in (p.delta_r1, p.bias)])


def auto_range_delta(delta_r1, vmax, grid, reach: int) -> torch.Tensor:
    """The auto-range fine step: ``delta_r1`` scaled so that the coarse
    range ``2**reach * delta_r1`` (``reach = n_r2 + m``) covers ``vmax``
    grid units.  The IEEE steps of the reference's ``auto_range_fit``, which
    the K1 kernel repeats: a correctly rounded division by ``grid``, an
    exact one by ``2**reach``, ``max(., 1e-6)``, one multiply.  Stays on
    the device: no host sync."""
    span = vmax / torch.as_tensor(grid, dtype=torch.float32,
                                  device=vmax.device)
    scale = torch.clamp_min(span / 2.0 ** reach, 1e-6)
    return torch.as_tensor(delta_r1, dtype=torch.float32,
                           device=scale.device) * scale


def make_params(delta_r1: float = 1.0, bias: float = 0.0, device=None,
                **kw) -> TRQParams:
    return TRQParams(
        delta_r1=torch.as_tensor(delta_r1, dtype=torch.float32,
                                 device=device),
        bias=torch.as_tensor(bias, dtype=torch.float32, device=device),
        **kw)


# ---------------------------------------------------------------------------
# Eq. 1 — uniform quantization
# ---------------------------------------------------------------------------

def uniform_code(x: torch.Tensor, delta, k: int) -> torch.Tensor:
    levels = 2 ** k - 1
    # floor(x + 0.5), *not* torch.round: SAR comparison against
    # (idx - 1/2)*LSB rounds half away from zero, torch.round is half-even
    c = torch.floor(x / delta + 0.5)
    return torch.clamp(c, 0, levels).to(torch.int32)


def uniform_quant(x: torch.Tensor, delta, k: int) -> torch.Tensor:
    """``Q_k(x, delta)`` of Eq. 1: round to the k-bit uniform grid."""
    return uniform_code(x, delta, k).to(torch.float32) * delta


# ---------------------------------------------------------------------------
# Eq. 7 — twin-range quantization
# ---------------------------------------------------------------------------

def in_r1(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """Range-detect phase of the modified SAR logic (1 extra comparison)."""
    return (x >= p.offset) & (x < p.theta)


def _trq_unsigned(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    fine = p.offset + uniform_quant(x - p.offset, p.delta_r1, p.n_r1)
    coarse = uniform_quant(x, p.delta_r2, p.n_r2)
    return torch.where(in_r1(x, p), fine, coarse)


def _maybe_signed(x, p: TRQParams, fn):
    if not p.signed:
        return fn(x)
    return torch.sign(x) * fn(torch.abs(x))


def trq_quant(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """``T_k`` of Eq. 7: R1 hit -> offset + Q_{n_r1}(x - offset, delta_r1);
    R1 miss -> Q_{n_r2}(x, delta_r2)."""
    if p.mode == "uniform":
        return _maybe_signed(x, p,
                             lambda a: uniform_quant(a, p.delta_r2, p.n_r2))
    return _maybe_signed(x, p, lambda a: _trq_unsigned(a, p))


def trq_quant_ste(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """Straight-through estimator: forward = trq_quant, backward = identity."""
    return x + (trq_quant(x, p) - x).detach()


# ---------------------------------------------------------------------------
# A/D operation counting (paper Eq. 6 / Eq. 9)
# ---------------------------------------------------------------------------

def trq_ad_ops(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """SAR comparator cycles per conversion (int32):
    twin: nu + (n_r1 if in R1 else n_r2); uniform: n_r2."""
    xa = torch.abs(x) if p.signed else x
    if p.mode == "uniform":
        return torch.full(xa.shape, p.n_r2, dtype=torch.int32,
                          device=xa.device)
    r1 = torch.full(xa.shape, p.n_r1 + p.nu, dtype=torch.int32,
                    device=xa.device)
    return torch.where(in_r1(xa, p), r1, r1.new_full((), p.n_r2 + p.nu))


def trq_quant_with_ops(x: torch.Tensor, p: TRQParams):
    """Quantize and count in one call: ``(trq_quant(x, p), trq_ad_ops(x,
    p))``, the pair the fused kernels return."""
    return trq_quant(x, p), trq_ad_ops(x, p)


# ---------------------------------------------------------------------------
# Quantization error (Eq. 10 objective) and the ideal case (Eq. 11)
# ---------------------------------------------------------------------------

def quant_mse(x: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """Mean squared quantization error of ``x`` under ``p``."""
    return torch.mean(torch.square(trq_quant(x, p) - x))


def ideal_params(r_ideal: int, n_r1: int, n_r2: int) -> TRQParams:
    """Eq. 11: ``delta_r1 = 1`` (lossless in R1), ``n_r2 + m = r_ideal``,
    ``bias = 0``; ``r_ideal = ceil(log2(y_max - y_min + 1))`` is the
    lossless resolution of the integer-valued bit-line output."""
    m = max(r_ideal - n_r2, 0)
    return make_params(delta_r1=1.0, bias=0.0, n_r1=n_r1, n_r2=n_r2, m=m)

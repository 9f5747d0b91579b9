"""Energy model — paper Eq. 4 / Eq. 6 / Eq. 9 and the Fig. 7 breakdown
(port of ``repro.core.energy``: the accounting, the layer and model
reports and the system power breakdown).

As in the paper, the *ratios* are the reproducible quantity: the TRQ claim
(ADC dynamic energy compressed to 42-62%) depends only on A/D-operation
counts, which this model takes exactly from the datapath.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from .trq import TRQParams, trq_ad_ops

E_OP_PJ = 0.25          # energy per A/D operation (8b SAR [20]: ~2 pJ / 8 ops)
R_ADC_DEFAULT = 8       # full-precision ADC resolution for 128x128, 1b cells
XBAR = 128              # crossbar rows/cols
R_CELL = 1              # bits per ReRAM cell (paper §V-A)
R_DA = 1                # DAC resolution (bit-serial inputs)
K_W = 8                 # weight bit-width (paper §V-A)
K_I = 8                 # input bit-width

# ISAAC-style static power shares of a tile (ADC-dominant; paper §I: >60%).
# Used only for the Fig. 7 system-level breakdown.
POWER_SHARES = {
    "ADC": 0.61,
    "DAC": 0.07,
    "crossbar": 0.11,
    "shift_add": 0.04,
    "buffers": 0.09,
    "noc": 0.08,
}


def conversions_per_mvm(in_features: int, out_features: int,
                        k_w: int = K_W, k_i: int = K_I, xbar: int = XBAR,
                        r_cell: int = R_CELL, r_da: int = R_DA) -> int:
    """Eq. 4: A/D conversions to produce one output vector (one MVM):
    (input bit slices) x (weight bit columns) x (row groups) x out."""
    slices = math.ceil(k_i / r_da)
    cols_per_weight = math.ceil(k_w / r_cell)
    groups = math.ceil(in_features / xbar)
    return slices * cols_per_weight * groups * out_features


def ideal_resolution(xbar: int = XBAR, r_da: int = R_DA,
                     r_cell: int = R_CELL) -> int:
    """Eq. 2: lossless ADC resolution for one bit-line (with 1-bit DAC and
    1-bit cells the sum is at most S, so R = log2(S) + 1)."""
    delta = -1 if (r_da == 1 and r_cell == 1) else 0
    return int(math.log2(xbar)) + r_da + r_cell + delta


def adc_energy_pj(n_ops_total) -> float:
    """E = e_op * N_A/D_ops (Eq. 6)."""
    return float(n_ops_total) * E_OP_PJ


def mean_ops_trq(y: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """Average A/D operations per conversion under TRQ for samples ``y``
    (the Eq. 9 objective divided by N * e_op), f32."""
    return torch.mean(trq_ad_ops(y, p).float())


def mean_ops_uniform(r_adc: int = R_ADC_DEFAULT) -> float:
    """Baseline: a K-bit SAR conversion always takes K operations."""
    return float(r_adc)


def trq_op_ratio(y: torch.Tensor, p: TRQParams,
                 r_adc: int = R_ADC_DEFAULT) -> torch.Tensor:
    """Fraction of baseline A/D operations remaining under TRQ (Fig. 6c)."""
    return mean_ops_trq(y, p) / mean_ops_uniform(r_adc)


# ---------------------------------------------------------------------------
# Layer / model accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerEnergyReport:
    name: str
    conversions: int            # A/D conversions per inference
    mean_ops_uniform: float     # ops/conversion, full-precision baseline
    mean_ops_trq: float         # ops/conversion, calibrated TRQ
    energy_uniform_pj: float
    energy_trq_pj: float

    @property
    def ratio(self) -> float:
        return self.energy_trq_pj / max(self.energy_uniform_pj, 1e-30)


def layer_report(name: str, in_features: int, out_features: int,
                 n_mvms: int, y_samples: torch.Tensor, p: TRQParams,
                 r_adc: int = R_ADC_DEFAULT) -> LayerEnergyReport:
    conv = conversions_per_mvm(in_features, out_features) * n_mvms
    ops_u = mean_ops_uniform(r_adc)
    y = torch.as_tensor(y_samples, dtype=torch.float32)
    ops_t = float(mean_ops_trq(y, p.to(y.device)))
    return LayerEnergyReport(
        name=name,
        conversions=conv,
        mean_ops_uniform=ops_u,
        mean_ops_trq=ops_t,
        energy_uniform_pj=adc_energy_pj(conv * ops_u),
        energy_trq_pj=adc_energy_pj(conv * ops_t),
    )


def model_adc_ratio(reports: Mapping[str, LayerEnergyReport]) -> float:
    """Conversion-weighted remaining-energy ratio across layers (Fig. 6c)."""
    e_t = sum(r.energy_trq_pj for r in reports.values())
    e_u = sum(r.energy_uniform_pj for r in reports.values())
    return e_t / max(e_u, 1e-30)


def system_power_breakdown(adc_ratio: float) -> dict:
    """Fig. 7: scale the ADC share by the TRQ ratio and report each
    component's share of the *original* total (so savings are visible)."""
    out = dict(POWER_SHARES)
    out["ADC"] = POWER_SHARES["ADC"] * adc_ratio
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out

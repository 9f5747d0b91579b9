"""Algorithm 1 — algorithm/hardware co-optimization (paper §IV), port of
``repro.core.calibrate``.

Layer-by-layer post-training search for the SAR configuration registers
(n_r1, n_r2, m, delta_r1, bias) that minimizes A/D-operation energy (Eq. 9)
subject to quantization MSE (Eq. 10) and an end-to-end accuracy constraint.
No retraining — only calibration samples of each layer's bit-line outputs.

The samples stay where they are: a layer's bit-line sums on the GPU (up to
gigabytes at full width) are subsampled by indices drawn on the host with
numpy's ``default_rng(0)`` — exactly the reference's draw — and gathered
on the device.  Every candidate is scored with one launch of the
``trq_quant`` kernel (q and the per-conversion op count), and a layer's
scores cross to the host once.  The search logic is the reference's, line
for line, so identical samples pick identical registers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..kernels.trq_quant import trq_quant as trq_quant_kernel
from .distribution import DistributionInfo, classify, r_ideal_bits
from .energy import R_ADC_DEFAULT
from .trq import TRQParams, make_params

MAX_CALIB_SAMPLES = 65536


@dataclasses.dataclass
class LayerCalibration:
    params: TRQParams
    dist: DistributionInfo
    mse: float
    mean_ops: float            # avg A/D operations per conversion
    uniform_mse: float         # best N_R2-bit uniform quantizer on this layer
    uniform_ops: float
    chosen: str                # 'twin' | 'uniform'

    @property
    def op_ratio(self) -> float:
        """Remaining fraction of baseline (R_ADC-bit) A/D operations."""
        return self.mean_ops / float(R_ADC_DEFAULT)


def _subsample(y, n: int = MAX_CALIB_SAMPLES) -> torch.Tensor:
    """At most ``n`` samples of ``y`` (any shape, C order), f32, on y's
    device: the reference's index draw, gathered without flattening a copy
    of ``y``."""
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.asarray(y, np.float32))
    if y.numel() > n:
        idx = np.random.default_rng(0).choice(y.numel(), n, replace=False)
        where = np.unravel_index(idx, tuple(y.shape))
        y = y[tuple(torch.from_numpy(w).to(y.device) for w in where)]
    return y.reshape(-1).float()


def _scores(y: torch.Tensor, cands: Sequence[TRQParams]) -> list:
    """[(mse, mean_ops)] of every candidate on samples ``y``: one
    ``trq_quant`` launch per candidate; the registers go to the device and
    the scores come back to the host once."""
    if not cands:
        return []
    regs = torch.tensor([[float(p.delta_r1), float(p.bias)] for p in cands],
                        dtype=torch.float32).to(y.device)
    inv_n = 1.0 / y.numel()      # the reference's mean: sum * f32(1/n)
    rows = []
    for i, p in enumerate(cands):
        q, ops = trq_quant_kernel(
            y, p.replace(delta_r1=regs[i, 0], bias=regs[i, 1]))
        rows.append(torch.stack([torch.sum(torch.square(q - y)) * inv_n,
                                 ops.sum().float() * inv_n]))
    return [(float(a), float(b)) for a, b in torch.stack(rows).cpu().numpy()]


def _best_uniform(y: torch.Tensor, n_bits: int, v_grids: Sequence[float],
                  r_adc: int) -> tuple:
    """Best plain N-bit uniform ADC over the V_grid candidates (Alg.1 l.23).

    The V_grid candidates are expressed on the R_ADC-bit base grid; an N-bit
    uniform ADC re-uses them scaled by 2**(r_adc - n_bits) so its 2**N levels
    still span the full range."""
    scale = 2.0 ** (r_adc - n_bits)
    cands = [make_params(delta_r1=float(vg * scale), bias=0.0, n_r1=n_bits,
                         n_r2=n_bits, m=0, mode="uniform") for vg in v_grids]
    best, best_mse = None, np.inf
    for p, (mse, _) in zip(cands, _scores(y, cands)):
        if mse < best_mse:
            best, best_mse = p, mse
    return best, best_mse


def _v_grid_candidates(y_max: float, r_adc: int, alpha: float, beta: float,
                       count: int) -> np.ndarray:
    base = y_max / (2 ** r_adc - 1)
    return np.linspace(alpha * base, beta * base, count, dtype=np.float64)


def calibrate_layer(y, *, n_max: int, r_adc: int = R_ADC_DEFAULT,
                    alpha: float = 0.1, beta: float = 1.2,
                    n_candidates: int = 50, m_max: int = 7,
                    max_bias_candidates: int = 16) -> LayerCalibration:
    """Inner loop of Algorithm 1 (lines 5-17) for one layer.  ``y``: the
    layer's bit-line samples, a numpy array or a tensor on any device."""
    y = _subsample(y)
    dist = classify(y.cpu().numpy())
    r_ideal = dist.r_ideal
    # R2 is anchored at 0 (Eq. 7), so the coarse grid must *cover* [0, y_max]
    # even when the samples' span (r_ideal) starts above zero.
    r_cover = max(r_ideal, r_ideal_bits(min(dist.y_min, 0.0), dist.y_max))
    n_r2 = max(min(n_max, r_cover), 1)
    v_grids = _v_grid_candidates(dist.y_max, r_adc, alpha, beta, n_candidates)

    candidates: list = []
    if dist.kind in ("ideal", "normal"):
        # Eq. 11: lossless R1 on the integer grid; n_r2 + m = r_ideal.
        # n_r2 is additionally searched downward: a smaller n_r2 shortens
        # every R2 search ("early stopping") and gives the bias offset a
        # finer 2**m positioning granularity (§IV-B).
        for n_r2_c in range(1, n_r2 + 1):
            m = max(r_cover - n_r2_c, 0)
            bias_opts = [0]
            if dist.kind == "normal" and m > 0:
                # offsets are multiples of 2**n_r1 * delta_r1; enumerating the
                # paper's 0..2**m-1 integer range, capped for search cost
                step = max((2 ** m) // max_bias_candidates, 1)
                bias_opts = list(range(0, 2 ** m, step))
            for n_r1 in range(1, min(n_r2_c, n_max) + 1):
                for b in bias_opts:
                    candidates.append(make_params(
                        delta_r1=1.0, bias=float(b), n_r1=n_r1, n_r2=n_r2_c,
                        m=m, nu=1 if b == 0 else 2))
    else:
        # lines 13-16: n_r1 = n_r2; search m (and the V_grid scale) for the
        # early-stopping-in-both-ranges regime.
        for m in range(0, m_max + 1):
            rel = 2.0 ** (r_cover - n_r2 - m)   # Alg.1 line 15 (in V_grid units)
            for vg in v_grids:
                candidates.append(make_params(
                    delta_r1=float(vg * rel), bias=0.0,
                    n_r1=n_r2, n_r2=n_r2, m=m, nu=1))

    uni_p, uni_mse = _best_uniform(y, n_r2, v_grids, r_adc)
    uni_ops = float(n_r2)    # uniform N-bit conversion = N comparator cycles

    # Eq. 9 (energy) subject to Eq. 10 (MSE no worse than the uniform
    # fallback); among feasible candidates pick min ops, tie-break on MSE.
    best: Optional[tuple] = None
    for p, (mse, ops) in zip(candidates, _scores(y, candidates)):
        feasible = mse <= uni_mse * 1.05 + 1e-12
        key = (not feasible, ops, mse)
        if best is None or key < best[0]:
            best = (key, p, mse, ops)

    _, p_twin, mse_twin, ops_twin = best
    twin_feasible = mse_twin <= uni_mse * 1.05 + 1e-12
    # selection (Alg. 1 line 23): fewer ops at no accuracy cost -> twin;
    # otherwise take twin when it is *substantially* more accurate (the
    # outer accuracy loop then converts that margin into lower n_max).
    use_twin = (twin_feasible and ops_twin < uni_ops) or \
               (mse_twin <= 0.6 * uni_mse and ops_twin <= uni_ops + p_twin.nu)

    chosen_p = p_twin if use_twin else uni_p
    return LayerCalibration(
        params=chosen_p, dist=dist,
        mse=mse_twin if use_twin else uni_mse,
        mean_ops=ops_twin if use_twin else uni_ops,
        uniform_mse=uni_mse, uniform_ops=uni_ops,
        chosen="twin" if use_twin else "uniform",
    )


def calibrate_model(layer_samples: Mapping[str, object],
                    eval_fn: Optional[Callable[[Mapping[str, TRQParams]],
                                               float]] = None,
                    *, acc_threshold: float = 0.01,
                    r_adc: int = R_ADC_DEFAULT,
                    **layer_kw) -> dict:
    """Full Algorithm 1: iterate ``n_max`` downward from ``r_adc - 1`` while
    the end-to-end accuracy drop stays within ``acc_threshold``.

    ``eval_fn`` maps {layer: TRQParams} -> accuracy; when omitted the search
    runs a single pass at ``n_max = r_adc - 1`` (pure MSE/energy calibration).
    """
    n_max = r_adc - 1
    baseline_acc = None
    last_good: Optional[dict] = None

    while n_max >= 1:
        cal = {name: calibrate_layer(y, n_max=n_max, r_adc=r_adc, **layer_kw)
               for name, y in layer_samples.items()}
        if eval_fn is None:
            return cal
        acc = eval_fn({k: c.params for k, c in cal.items()})
        if baseline_acc is None:
            baseline_acc = acc
        if baseline_acc - acc > acc_threshold:
            break                       # Alg. 1 line 19-20
        last_good = cal
        n_max -= 1                      # Alg. 1 line 22

    return last_good if last_good is not None else cal


def to_quant_state(cal: Mapping[str, LayerCalibration], *,
                   signed: Optional[bool] = None, default=None):
    """Package an Algorithm-1 result as a per-layer
    :class:`~repro_torch.core.quant_state.QuantState` keyed by the
    calibrated layer names (exact-match rules).  ``signed=True`` flips every
    register set onto the signed per-group grid the LM fast path quantizes
    on; the ``bit_exact`` datapath takes them as calibrated."""
    from .quant_state import quant_state_from_calibration
    return quant_state_from_calibration(cal, signed=signed, default=default)


def summarize(cal: Mapping[str, LayerCalibration]) -> dict:
    ops = [c.mean_ops for c in cal.values()]
    return {
        "layers": len(cal),
        "twin_layers": sum(c.chosen == "twin" for c in cal.values()),
        "mean_ops": float(np.mean(ops)) if ops else 0.0,
        "op_ratio_vs_8b": float(np.mean([c.op_ratio for c in cal.values()]))
        if ops else 0.0,
    }

"""Algorithm 1 — algorithm/hardware co-optimization (paper §IV), port of
``repro.core.calibrate``.

Layer-by-layer post-training search for the SAR configuration registers
(n_r1, n_r2, m, delta_r1, bias) that minimizes A/D-operation energy (Eq. 9)
subject to quantization MSE (Eq. 10) and an end-to-end accuracy constraint.
No retraining — only calibration samples of each layer's bit-line outputs.

The samples stay where they are: a layer's bit-line sums on the GPU (up to
gigabytes at full width) are subsampled by indices drawn on the host with
numpy's ``default_rng(0)`` — exactly the reference's draw — and gathered
on the device.  All of a layer's candidates, the uniform fallbacks and the
TRQ register sets, are scored in one ``trq_score`` call, and the (C, 2)
sums cross to the host once.

How the scores are summed, and why: the search compares MSEs (the
feasibility test and the tie-break on equal ops), so sums whose last bits
depend on the reduction order could make the CUDA kernel and its plain
version pick different registers.  Squared errors (each squared in f32, as
the reference's ``jnp.square(q - x)``) are therefore summed in f64 and op
counts in int64; each total is rounded once to f32 and multiplied by
``f32(1/n)``, the reference's mean.  On integral steps over integer
bit-line sums (every TRQ candidate of an ``ideal`` or ``normal`` layer)
each squared error is an integer below 2^15 and 65,536 of them stay below
2^31, so the f64 sum is exact in any order and both routes give the same
bits; on a fractional step (the uniform fallbacks, an ``other`` layer's
candidates) the two f64 sums differ by a few ulps at most and round to the
same f32 unless they straddle a rounding midpoint.  The search logic is
the reference's, line for line — the same candidate order, keys and
first-wins ties — so identical samples pick identical registers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..kernels.trq_quant import score_table, trq_score
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
    ``trq_score`` launch and one read of the sums (see the module note)."""
    sq, ops = trq_score(y, *score_table(cands, y.device))
    sums = torch.stack((sq, ops.double()), 1).cpu().numpy()
    inv_n = np.float32(1.0 / y.numel())      # the reference's mean
    return [(float(a), float(b)) for a, b in sums.astype(np.float32) * inv_n]


def _best_uniform(cands: Sequence[TRQParams], scores: Sequence) -> tuple:
    """Best plain N-bit uniform ADC over the V_grid candidates (Alg.1 l.23):
    the first of the least MSE."""
    best, best_mse = None, np.inf
    for p, (mse, _) in zip(cands, scores):
        if mse < best_mse:
            best, best_mse = p, mse
    return best, best_mse


def _v_grid_candidates(y_max: float, r_adc: int, alpha: float, beta: float,
                       count: int) -> np.ndarray:
    base = y_max / (2 ** r_adc - 1)
    return np.linspace(alpha * base, beta * base, count, dtype=np.float64)


def layer_candidates(dist: DistributionInfo, *, n_max: int,
                     r_adc: int = R_ADC_DEFAULT, alpha: float = 0.1,
                     beta: float = 1.2, n_candidates: int = 50,
                     m_max: int = 7, max_bias_candidates: int = 16) -> tuple:
    """Algorithm 1's candidates for a layer judged ``dist`` (lines 5-16 and
    line 23's fallback): ``(n_r2, uniform, twin)``, the plain N_R2-bit ADCs
    over the V_grid and the TRQ register sets, each in the reference's
    order."""
    r_ideal = dist.r_ideal
    # R2 is anchored at 0 (Eq. 7), so the coarse grid must *cover* [0, y_max]
    # even when the samples' span (r_ideal) starts above zero.
    r_cover = max(r_ideal, r_ideal_bits(min(dist.y_min, 0.0), dist.y_max))
    n_r2 = max(min(n_max, r_cover), 1)
    v_grids = _v_grid_candidates(dist.y_max, r_adc, alpha, beta, n_candidates)

    # The V_grid candidates are expressed on the R_ADC-bit base grid; an
    # N-bit uniform ADC re-uses them scaled by 2**(r_adc - n_bits) so its
    # 2**N levels still span the full range.
    scale = 2.0 ** (r_adc - n_r2)
    uniform = [make_params(delta_r1=float(vg * scale), bias=0.0, n_r1=n_r2,
                           n_r2=n_r2, m=0, mode="uniform") for vg in v_grids]

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
    return n_r2, uniform, candidates


def calibrate_layer(y, *, n_max: int, **search) -> LayerCalibration:
    """Inner loop of Algorithm 1 (lines 5-17) for one layer.  ``y``: the
    layer's bit-line samples, a numpy array or a tensor on any device;
    ``search``: ``r_adc`` and the candidate grid's knobs
    (:func:`layer_candidates`)."""
    y = _subsample(y)
    dist = classify(y.cpu().numpy())
    n_r2, uniform, candidates = layer_candidates(dist, n_max=n_max, **search)
    scores = _scores(y, uniform + candidates)

    uni_p, uni_mse = _best_uniform(uniform, scores[:len(uniform)])
    uni_ops = float(n_r2)    # uniform N-bit conversion = N comparator cycles

    # Eq. 9 (energy) subject to Eq. 10 (MSE no worse than the uniform
    # fallback); among feasible candidates pick min ops, tie-break on MSE.
    best: Optional[tuple] = None
    for p, (mse, ops) in zip(candidates, scores[len(uniform):]):
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

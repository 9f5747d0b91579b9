"""Bit-line value-distribution analysis — paper §III-A / Fig. 3a and the
distribution-type judgement of Algorithm 1 (line 5).

The paper distinguishes three regimes of the BL partial-sum distribution:

* ``ideal``  — heavily skewed toward zero ("the majority of samples are
  concentrated in a small interval close to zero", Fig. 3a).  TRQ gets a
  lossless R1 with ``delta_r1 = 1`` (Eq. 11).
* ``normal`` — strongly unimodal, low variance, mode away from zero
  (§IV-B): same as ideal but with an R1 ``bias`` offset.
* ``other``  — weak unimodal / multi-modal / flat: both ranges run "early
  stopping" with ``n_r1 = n_r2`` and searched scales.

A copy of ``repro.core.distribution`` (numpy only): Algorithm 1 judges each
layer on the host from its subsampled bit-line samples.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class DistributionInfo:
    kind: str                # 'ideal' | 'normal' | 'other'
    y_min: float
    y_max: float
    r_ideal: int             # ceil(log2(y_max - y_min + 1))  (Alg. 1 line 7)
    mode_center: float       # histogram mode location
    mass_near_mode: float    # fraction of samples within the narrow window
    n_peaks: int


def r_ideal_bits(y_min: float, y_max: float) -> int:
    span = max(y_max - y_min, 0.0)
    return max(int(math.ceil(math.log2(span + 1.0))), 1)


def classify(y, sweet_mass: float = 0.60, max_window_frac: float = 0.25,
             bins: int = 128) -> DistributionInfo:
    """Judge the distribution type of a layer's BL outputs (Alg. 1 line 5).

    A "sweet spot" R1 exists when some window no wider than
    ``max_window_frac`` of the full range captures at least ``sweet_mass`` of
    the samples.  If that window hugs zero the layer is the paper's *ideal*
    case; if it sits away from zero but the distribution is unimodal it is
    the *normal* (offset/bias) case; otherwise *other*.
    """
    y = np.asarray(y, np.float64).ravel()
    y_min, y_max = float(y.min()), float(y.max())
    span = max(y_max - y_min, 1e-12)

    # integer-valued BL sums: keep bin width >= 1 to avoid comb artifacts
    is_int = bool(np.all(y == np.round(y)))
    n_bins = min(bins, max(int(span) + 1, 2)) if is_int else bins
    hist, edges = np.histogram(y, bins=n_bins, range=(y_min, y_min + span))
    frac = hist / max(hist.sum(), 1)
    mode_bin = int(np.argmax(frac))
    mode_center = 0.5 * (edges[mode_bin] + edges[mode_bin + 1])

    # smallest dyadic window (1/32 .. max_window_frac of range, anchored near
    # the mode) capturing >= sweet_mass of the samples
    best_mass, best_frac = 0.0, None
    for wf in (1 / 32, 1 / 16, 1 / 8, 1 / 4):
        if wf > max_window_frac + 1e-9:
            break
        win = wf * span
        lo = max(y_min, mode_center - 0.5 * win)
        mass = float(((y >= lo) & (y < lo + win)).mean())
        if mass > best_mass:
            best_mass = mass
        if mass >= sweet_mass and best_frac is None:
            best_frac = wf

    # peak count on the (comb-free) histogram: local maxima above 20% of the
    # main peak, with plateaus merged; 3-bin smoothing kills noise crossings
    smooth = np.convolve(frac, np.ones(3) / 3.0, mode="same")
    sig = smooth > 0.2 * smooth.max()
    rising = np.diff(sig.astype(np.int8)) == 1
    n_peaks = max(int(rising.sum()) + int(sig[0]), 1)

    has_sweet_spot = best_frac is not None
    near_zero = mode_center <= y_min + 0.25 * span * (best_frac or 0.25)
    if has_sweet_spot and near_zero and n_peaks <= 2:
        kind = "ideal"
    elif has_sweet_spot and n_peaks <= 2:
        kind = "normal"
    else:
        kind = "other"

    return DistributionInfo(
        kind=kind, y_min=y_min, y_max=y_max,
        r_ideal=r_ideal_bits(y_min, y_max),
        mode_center=mode_center, mass_near_mode=best_mass, n_peaks=n_peaks,
    )


def histogram_summary(y, bins: int = 64) -> dict:
    """Raw material for the Fig. 3a reproduction benchmark."""
    y = np.asarray(y, np.float64).ravel()
    hist, edges = np.histogram(y, bins=bins)
    q = np.quantile(y, [0.5, 0.9, 0.99, 0.999])
    return {
        "hist": hist.tolist(),
        "edges": edges.tolist(),
        "mean": float(y.mean()),
        "std": float(y.std()),
        "max": float(y.max()),
        "quantiles": {"p50": float(q[0]), "p90": float(q[1]),
                      "p99": float(q[2]), "p999": float(q[3])},
    }

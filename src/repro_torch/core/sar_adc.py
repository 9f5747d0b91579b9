"""Behavioral model of the (modified) SAR ADC — paper §II-D and §III-D,
port of ``repro.core.sar_adc``.

Two levels of fidelity:

* ``sar_search_*``: the cycle-accurate successive-approximation search,
  a Python loop over the comparator cycles (the Eq. 5 trajectory, the
  reference's ``lax.fori_loop``), thresholds ``(trial - 1/2) * lsb`` in
  f32.  The tests use it to prove the closed forms match the search.
* ``sar_convert_*``: the closed forms the rest of the port uses.

Both return the code(s) and ``n_ops``, the A/D operations (comparator
cycles) of each conversion, the paper's energy unit (Eq. 6).
"""
from __future__ import annotations

import torch

from .trq import TRQParams, in_r1, trq_ad_ops, uniform_code


# ---------------------------------------------------------------------------
# Cycle-accurate search (Eq. 5)
# ---------------------------------------------------------------------------

def sar_search_uniform(v, k: int, lsb):
    """K-cycle binary search on the uniform grid with thresholds
    ``(idx - 1/2) * lsb`` (paper Fig. 2a).  Returns (code, n_ops=K), int32."""
    v = torch.as_tensor(v, dtype=torch.float32)
    lsb = torch.as_tensor(lsb, dtype=torch.float32, device=v.device)
    code = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for i in range(k):
        bit = k - 1 - i
        trial = code | (1 << bit)                       # try this bit at 1
        th = (trial.float() - 0.5) * lsb                # threshold voltage
        keep = (v >= th).to(torch.int32)
        code = code | (keep << bit)
    return code, torch.full(v.shape, k, dtype=torch.int32, device=v.device)


def sar_search_trq(v, p: TRQParams):
    """Cycle-accurate twin-range search (paper Fig. 4a): a range detect
    against the R1 edges, then a binary search with step ``delta_r1``
    inside R1 ("early bird") or ``delta_r2`` over the full range, cut at
    ``n_r2`` cycles ("early stopping").  Returns (msb, payload, n_ops)."""
    v = torch.as_tensor(v, dtype=torch.float32)
    p = p.to(v.device)
    hit = in_r1(v, p)
    fine_code, _ = sar_search_uniform(v - p.offset, p.n_r1, p.delta_r1)
    coarse_code, _ = sar_search_uniform(v, p.n_r2, p.delta_r2)
    payload = torch.where(hit, fine_code, coarse_code)
    msb = (~hit).to(torch.int32)
    return msb, payload, trq_ad_ops(v, p)


# ---------------------------------------------------------------------------
# Closed-form converters
# ---------------------------------------------------------------------------

def sar_convert_uniform(v, k: int, lsb):
    """Closed form of ``sar_search_uniform``: code = clamp(round(v/lsb))."""
    v = torch.as_tensor(v, dtype=torch.float32)
    return (uniform_code(v, lsb, k),
            torch.full(v.shape, k, dtype=torch.int32, device=v.device))


def sar_convert_trq(v, p: TRQParams):
    """Closed form of ``sar_search_trq`` (same return signature)."""
    v = torch.as_tensor(v, dtype=torch.float32)
    p = p.to(v.device)
    hit = in_r1(v, p)
    fine = uniform_code(v - p.offset, p.delta_r1, p.n_r1)
    coarse = uniform_code(v, p.delta_r2, p.n_r2)
    payload = torch.where(hit, fine, coarse)
    msb = (~hit).to(torch.int32)
    return msb, payload, trq_ad_ops(v, p)

"""Energy model — the part of ``repro.core.energy`` the serving path needs.

Eq. 6: the SAR conversion energy is ``E_OP_PJ`` per A/D operation, so the
energy of a call follows exactly from its op count.
"""
from __future__ import annotations

E_OP_PJ = 0.25          # energy per A/D operation (8b SAR [20]: ~2 pJ / 8 ops)


def adc_energy_pj(n_ops_total) -> float:
    """E = e_op * N_A/D_ops (Eq. 6)."""
    return float(n_ops_total) * E_OP_PJ

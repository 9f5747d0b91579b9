"""Plain PyTorch versions of the ``trq_quant`` kernel's two entries: the
port's ``core.trq`` on the whole tensor, with the kernel's operand
contracts.  The CPU tests use them, and ``chip_smoke.py`` holds the CUDA
kernel against them on the card; they never run on the main path when a
card is present."""
from __future__ import annotations

import torch

from ...core.trq import TRQParams, trq_ad_ops, trq_quant
from .kernel import MODES


def trq_quant_ref(x: torch.Tensor, scalars: torch.Tensor, *, n_r1: int,
                  n_r2: int, m: int, nu: int = 1, mode: str = "twin",
                  signed: bool = False):
    """x: f32 or f16 of any shape; scalars: [delta_r1, bias] f32.  Returns
    (q f32, ops int32), both with x's shape."""
    p = TRQParams(delta_r1=scalars[0], bias=scalars[1], n_r1=n_r1,
                  n_r2=n_r2, m=m, nu=nu, mode=mode, signed=signed)
    xf = x.float()          # compare in f32, as the kernel does
    return trq_quant(xf, p), trq_ad_ops(xf, p)


def trq_score_ref(y: torch.Tensor, fregs: torch.Tensor,
                  iregs: torch.Tensor):
    """y: n samples, f32 or f16; fregs: (C, 2) f32 [delta_r1, bias];
    iregs: (C, 6) int32 [n_r1, n_r2, m, nu, mode, signed].  Returns
    (sum_sq f64, sum_ops int64), each (C,): per candidate
    ``torch.sum((q - y).square(), dtype=float64)`` of the f32 errors and
    the op counts summed in int64."""
    yf = y.float().reshape(-1)
    names = {v: k for k, v in MODES.items()}
    sq, ops = [], []
    for c, (n_r1, n_r2, m, nu, mode, signed) in enumerate(iregs.tolist()):
        if mode not in names:
            raise ValueError(f"trq_score: unknown mode code {mode}")
        q, o = trq_quant_ref(yf, fregs[c], n_r1=n_r1, n_r2=n_r2, m=m, nu=nu,
                             mode=names[mode], signed=bool(signed))
        sq.append(torch.sum((q - yf).square(), dtype=torch.float64))
        ops.append(o.sum(dtype=torch.int64))
    if not sq:
        return (torch.zeros(0, dtype=torch.float64, device=y.device),
                torch.zeros(0, dtype=torch.int64, device=y.device))
    return torch.stack(sq), torch.stack(ops)

"""Plain PyTorch version of the ``trq_quant`` kernel: the port's
``core.trq`` on the whole tensor, with the kernel's operand contract.  The
CPU tests use it, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card; it never runs on the main path when a card is present."""
from __future__ import annotations

import torch

from ...core.trq import TRQParams, trq_ad_ops, trq_quant


def trq_quant_ref(x: torch.Tensor, scalars: torch.Tensor, *, n_r1: int,
                  n_r2: int, m: int, nu: int = 1, mode: str = "twin",
                  signed: bool = False):
    """x: f32 or f16 of any shape; scalars: [delta_r1, bias] f32.  Returns
    (q f32, ops int32), both with x's shape."""
    p = TRQParams(delta_r1=scalars[0], bias=scalars[1], n_r1=n_r1,
                  n_r2=n_r2, m=m, nu=nu, mode=mode, signed=signed)
    xf = x.float()          # compare in f32, as the kernel does
    return trq_quant(xf, p), trq_ad_ops(xf, p)

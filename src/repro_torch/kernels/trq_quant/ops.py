"""Public wrapper of ``trq_quant``: device dispatch, the counterpart of
``repro.kernels.trq_quant_pallas``.

A CPU tensor runs the plain version (``ref.py``), a CUDA tensor the CUDA
kernel (``kernel.py``); nothing falls back from one to the other.  The
kernel walks the flattened tensor, so unlike the TPU wrapper nothing is
padded to tiles.
"""
from __future__ import annotations

import torch

from ...core.trq import TRQParams, register_scalars
from ..build import route
from .kernel import trq_quant_cuda
from .ref import trq_quant_ref


def trq_quant(x: torch.Tensor, p: TRQParams):
    """TRQ fake-quant and A/D op count of ``x`` (any shape; f16 is
    widened).  Returns ``(q f32, ops int32)``, both with x's shape."""
    if x.dtype not in (torch.float32, torch.float16):
        x = x.float()
    fn = trq_quant_ref if route(x) == "cpu" else trq_quant_cuda
    return fn(x.contiguous(), register_scalars(p, x.device), n_r1=p.n_r1,
              n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode, signed=p.signed)

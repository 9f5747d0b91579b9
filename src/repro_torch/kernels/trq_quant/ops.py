"""Public wrappers of ``trq_quant``: device dispatch.  ``trq_quant`` is the
counterpart of ``repro.kernels.trq_quant_pallas``; ``trq_score`` scores a
table of candidate registers (``score_table``) on one set of samples, the
sums Algorithm 1 reduces each candidate's q and ops to.

A CPU tensor runs the plain version (``ref.py``), a CUDA tensor the CUDA
kernel (``kernel.py``); nothing falls back from one to the other.  The
kernel walks the flattened tensor, so unlike the TPU wrapper nothing is
padded to tiles.
"""
from __future__ import annotations

import torch

from typing import Sequence

from ...core.trq import TRQParams, register_scalars
from ..build import route
from .kernel import MODES, SCORE_IREGS, trq_quant_cuda, trq_score_cuda
from .ref import trq_quant_ref, trq_score_ref


def trq_quant(x: torch.Tensor, p: TRQParams):
    """TRQ fake-quant and A/D op count of ``x`` (any shape; f16 is
    widened).  Returns ``(q f32, ops int32)``, both with x's shape."""
    if x.dtype not in (torch.float32, torch.float16):
        x = x.float()
    fn = trq_quant_ref if route(x) == "cpu" else trq_quant_cuda
    return fn(x.contiguous(), register_scalars(p, x.device), n_r1=p.n_r1,
              n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode, signed=p.signed)


def score_table(cands: Sequence[TRQParams], device=None):
    """The register table of ``cands`` for ``trq_score``: (C, 2) f32 rows
    [delta_r1, bias] and (C, 6) int32 rows ``SCORE_IREGS``, built on the
    host and moved to ``device`` in one copy each.  Refuses widths outside
    [0, 24] and an unknown mode."""
    for p in cands:
        if p.mode not in MODES:
            raise ValueError(f"trq_score: unknown mode {p.mode!r}")
        if not all(0 <= r <= 24 for r in (p.n_r1, p.n_r2, p.m, p.nu)):
            raise ValueError(f"trq_score: register widths out of range: "
                             f"{p}")
    fregs = torch.tensor([[float(p.delta_r1), float(p.bias)] for p in cands],
                         dtype=torch.float32).reshape(-1, 2)
    iregs = torch.tensor([[p.n_r1, p.n_r2, p.m, p.nu, MODES[p.mode],
                           int(p.signed)] for p in cands],
                         dtype=torch.int32).reshape(-1, len(SCORE_IREGS))
    return fregs.to(device), iregs.to(device)


def trq_score(y: torch.Tensor, fregs: torch.Tensor, iregs: torch.Tensor):
    """Per-candidate sums of the TRQ error and op count on samples ``y``
    (any shape; f16 is widened): ``(sum_sq f64, sum_ops int64)``, each
    (C,), for the table ``(fregs, iregs)`` of ``score_table`` on y's
    device."""
    if fregs.device != y.device or iregs.device != y.device:
        raise ValueError(f"trq_score: mixed devices: samples on {y.device}, "
                         f"table on {fregs.device} and {iregs.device}")
    if y.dtype not in (torch.float32, torch.float16):
        y = y.float()
    fn = trq_score_ref if route(y) == "cpu" else trq_score_cuda
    return fn(y.contiguous().reshape(-1), fregs, iregs)

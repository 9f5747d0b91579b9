"""Public wrapper of ``trq_group_mvm``: device dispatch and lead dims.

A CPU tensor runs the plain version (``ref.py``), a CUDA tensor the CUDA
kernel (``kernel.py``); nothing falls back from one to the other.  Unlike
the TPU wrapper there is no tile padding here: the kernel masks ragged M,
K and N edges itself.  Weights go in as the model holds them (bf16 on the
serving path): the kernel widens them in registers.
"""
from __future__ import annotations

import torch

from ...core.trq import TRQParams, register_scalars
from ..build import route
from .kernel import (WEIGHT_DTYPES, trq_group_mvm_cuda,
                     trq_group_mvm_psums_cuda, trq_group_mvm_quantize_cuda)
from .ref import (trq_group_mvm_psums_ref, trq_group_mvm_quantize_ref,
                  trq_group_mvm_ref)


def pack_scalars(p: TRQParams, grid, device) -> torch.Tensor:
    """[delta_r1, bias, grid] as one f32 device tensor (no host sync)."""
    return torch.cat([register_scalars(p, device), torch.as_tensor(
        grid, dtype=torch.float32, device=device).reshape(1)])


def trq_group_mvm_2d(a: torch.Tensor, w: torch.Tensor, scalars, *,
                     n_r1: int, n_r2: int, m: int, nu: int = 1,
                     mode: str = "twin", auto_range: bool = False,
                     reduce_cells=None):
    """(M, K) f32 x (K, N) bf16 or f32 per-group TRQ matmul -> (y f32, ops
    int64).  ``auto_range`` fits ``delta_r1`` to the call's own partial
    sums, in the same pass that reads the weights.  With ``auto_range``
    and ``reduce_cells`` (ranks that each hold a block of the rows), the
    split launch runs instead: pass 1, ``reduce_cells(cells)`` (an
    in-place MAX of the int32 maximum cells over the ranks), pass 2 on
    the reduced cells, so the register is the one a call on every rank's
    rows fits."""
    cpu = route(a) == "cpu"
    if auto_range and reduce_cells is not None:
        psums, quantize = (trq_group_mvm_psums_ref,
                           trq_group_mvm_quantize_ref) if cpu else \
            (trq_group_mvm_psums_cuda, trq_group_mvm_quantize_cuda)
        part, stats = psums(a, w)
        reduce_cells(stats[1:].view(torch.int32))
        return quantize(part, stats, scalars, a.shape[1], n_r1=n_r1,
                        n_r2=n_r2, m=m, nu=nu, mode=mode)
    fn = trq_group_mvm_ref if cpu else trq_group_mvm_cuda
    return fn(a, w, scalars, n_r1=n_r1, n_r2=n_r2, m=m, nu=nu, mode=mode,
              auto_range=auto_range)


def weight_operand(w: torch.Tensor) -> torch.Tensor:
    """``w`` as the kernel reads it: bf16 or f32 as it is, any other dtype
    widened to f32."""
    return (w if w.dtype in WEIGHT_DTYPES else w.float()).contiguous()


def trq_group_mvm(a: torch.Tensor, w: torch.Tensor, p: TRQParams,
                  a_scale=1.0, w_scale=1.0, *, with_ops: bool = False,
                  auto_range: bool = False, reduce_cells=None):
    """Per-128-row-group signed-TRQ matmul: a (..., K) @ w (K, N), the
    counterpart of ``repro.kernels.trq_group_mvm_pallas``.  With
    ``with_ops`` also returns the total A/D operations (int64); with
    ``auto_range`` first fits ``delta_r1`` as ``auto_range_fit`` does
    (over every rank's rows through ``reduce_cells``, as
    :func:`trq_group_mvm_2d`)."""
    lead = a.shape[:-1]
    k = a.shape[-1]
    n = w.shape[1]
    grid = (torch.as_tensor(a_scale, dtype=torch.float32, device=a.device)
            * torch.as_tensor(w_scale, dtype=torch.float32, device=a.device))
    y, ops = trq_group_mvm_2d(
        a.reshape(-1, k).float().contiguous(), weight_operand(w),
        pack_scalars(p, grid, a.device), n_r1=p.n_r1, n_r2=p.n_r2, m=p.m,
        nu=p.nu, mode=p.mode, auto_range=auto_range,
        reduce_cells=reduce_cells)
    y = y.reshape(*lead, n)
    return (y, ops) if with_ops else y

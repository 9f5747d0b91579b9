"""Plain PyTorch version of the ``xbar_mvm`` kernel, with the kernel's
operand contract (bit-mask planes).  Like ``repro.kernels.xbar_mvm.ref`` it
is an einsum over f32 0/1 planes — the masks are unpacked back to planes,
and no popcount or quantizer table is shared with the kernel — then the
unsigned TRQ of ``core.trq`` (or the lossless mode) and the shift-add,
accumulated in the kernel's order (group outer, then input bit b, then
weight bit c, a fresh f32 sum per group).  The CPU tests use it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card; it never
runs on the main path when a card is present."""
from __future__ import annotations

import torch

from ...core.trq import TRQParams, trq_ad_ops, trq_quant

XBAR = 128


def unpack_planes(mask: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 bit masks -> (..., 128) f32 0/1 planes (bit r of word
    q is row 32*q + r)."""
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = (mask.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*mask.shape[:-1], XBAR).float()


def xbar_mvm_ref(a_mask: torch.Tensor, w_mask: torch.Tensor,
                 scalars: torch.Tensor, *, n_r1: int = 4, n_r2: int = 4,
                 m: int = 3, nu: int = 1, mode: str = "twin",
                 lossless: bool = False, r_adc: int = 8,
                 per_output: bool = False):
    """a_mask: (k_i, M, G, 4) int32; w_mask: (k_w, G, N, 4) int32;
    scalars: [delta_r1, bias] f32.  Returns (acc (M, N) f32 before the
    zero-point correction, ops 0-dim int64, per-output ops (M, N) int32 or
    None)."""
    k_i, mm, g, _ = a_mask.shape
    k_w, _, n, _ = w_mask.shape
    a_p = unpack_planes(a_mask)                          # (k_i, M, G, X)
    w_p = unpack_planes(w_mask).transpose(2, 3)          # (k_w, G, X, N)
    psum = torch.einsum("imgx,jgxn->ijgmn", a_p, w_p)    # (k_i,k_w,G,M,N)
    if lossless:
        q = psum
        ops = torch.full(psum.shape, r_adc, dtype=torch.int32,
                         device=psum.device)
    else:
        p = TRQParams(delta_r1=scalars[0], bias=scalars[1], n_r1=n_r1,
                      n_r2=n_r2, m=m, nu=nu, mode=mode, signed=False)
        q, ops = trq_quant(psum, p), trq_ad_ops(psum, p)
    acc_g = torch.zeros((g, mm, n), dtype=torch.float32, device=psum.device)
    for b in range(k_i):
        for c in range(k_w):
            acc_g = acc_g + q[b, c] * float(2 ** (b + c))
    acc = torch.zeros((mm, n), dtype=torch.float32, device=psum.device)
    for gi in range(g):
        acc = acc + acc_g[gi]
    per = ops.sum(dim=(0, 1, 2), dtype=torch.int32)
    return acc, per.sum(dtype=torch.int64), per if per_output else None

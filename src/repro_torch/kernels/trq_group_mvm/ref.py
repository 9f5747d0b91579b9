"""Plain PyTorch version of the ``trq_group_mvm`` kernel: the per-group TRQ
matmul of ``repro.pim.crossbar.fake_quant_mvm``, with the kernel's operand
contract.  The CPU tests use it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card; it never runs on the main path when a card
is present."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.trq import TRQParams, auto_range_delta, trq_ad_ops, trq_quant

XBAR = 128
STATS = 17      # the kernel's stats words: op total, 32 u32 maximum cells


def group_psums(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) -> the (M, G, N) f32 partial sums of the 128-row
    groups (K zero-padded to whole groups)."""
    mm, k = a.shape
    n = w.shape[1]
    pad = (-k) % XBAR
    g = (k + pad) // XBAR
    a_g = F.pad(a.float(), (0, pad)).reshape(mm, g, XBAR)
    w_g = F.pad(w.float(), (0, 0, 0, pad)).reshape(g, XBAR, n)
    return torch.einsum("mgx,gxn->mgn", a_g, w_g)


def trq_group_mvm_ref(a: torch.Tensor, w: torch.Tensor,
                      scalars: torch.Tensor, *, n_r1: int, n_r2: int, m: int,
                      nu: int = 1, mode: str = "twin",
                      auto_range: bool = False):
    """a: (M, K) f32; w: (K, N) bf16 or f32 (widened to f32, exactly);
    scalars: [delta_r1, bias, grid] f32.  With ``auto_range`` the partial
    sums' max |psum| scales ``delta_r1`` first (:func:`auto_range_delta`).
    Returns (y (M, N) f32, ops 0-dim int64 over the valid region)."""
    psum = group_psums(a, w)                            # (M, G, N) f32
    vmax = torch.amax(torch.abs(psum)) if auto_range else None
    return _quantize(psum, scalars, vmax, n_r1=n_r1, n_r2=n_r2, m=m, nu=nu,
                     mode=mode)


def trq_group_mvm_psums_ref(a: torch.Tensor, w: torch.Tensor):
    """Pass 1 of the split launch: (part (M, G, N) f32, stats (17,) int64
    laid out as the kernel's: word 0 zero, words 1..16 the 32 maximum
    cells, ``stats[1:].view(torch.int32)``, here cell 0 holding the bits of
    max |psum| and the rest 0)."""
    part = group_psums(a, w)
    stats = torch.zeros(STATS, dtype=torch.int64, device=a.device)
    stats[1:].view(torch.int32)[0] = torch.amax(torch.abs(part)).view(
        torch.int32)
    return part, stats


def trq_group_mvm_quantize_ref(part: torch.Tensor, stats: torch.Tensor,
                               scalars: torch.Tensor, k: int, *, n_r1: int,
                               n_r2: int, m: int, nu: int = 1,
                               mode: str = "twin"):
    """Pass 2 of the split launch: ``delta_r1`` fitted to the maximum of
    the cells in ``stats``, then the quantized sum.  Returns (y, ops),
    ops as ``stats[0]`` plus this call's count."""
    vmax = torch.amax(stats[1:].view(torch.int32)).view(torch.float32)
    y, ops = _quantize(part, scalars, vmax, n_r1=n_r1, n_r2=n_r2, m=m,
                       nu=nu, mode=mode)
    return y, stats[0] + ops


def _quantize(psum: torch.Tensor, scalars: torch.Tensor, vmax, *,
              n_r1: int, n_r2: int, m: int, nu: int, mode: str):
    """The quantized sum of (M, G, N) partial sums, ``delta_r1`` fitted to
    ``vmax`` unless it is None."""
    mm, g, n = psum.shape
    grid = scalars[2]
    delta_r1 = scalars[0]
    if vmax is not None:
        delta_r1 = auto_range_delta(delta_r1, vmax, grid, n_r2 + m)
    p = TRQParams(delta_r1=delta_r1, bias=scalars[1], n_r1=n_r1,
                  n_r2=n_r2, m=m, nu=nu, mode=mode, signed=True)
    scaled = psum / grid
    q = trq_quant(scaled, p) * grid
    # accumulate the groups in order, as the kernel's second pass does
    y = torch.zeros((mm, n), dtype=torch.float32, device=psum.device)
    for gi in range(g):
        y = y + q[:, gi]
    ops = trq_ad_ops(scaled, p).sum(dtype=torch.int64)
    return y, ops

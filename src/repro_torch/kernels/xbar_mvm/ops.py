"""Public wrappers of ``xbar_mvm``: bit-mask packing, device dispatch and
the zero-point correction.

A CPU tensor runs the plain version (``ref.py``), a CUDA tensor the CUDA
kernel (``kernel.py``); nothing falls back from one to the other.  Unlike
the TPU wrapper nothing is padded to tiles: the packer zero-fills the last
128-row group (a partial crossbar still converts every bit-line, so those
zero rows count) and the kernel masks ragged M and N itself.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.trq import TRQParams, register_scalars
from ..build import route
from .kernel import xbar_mvm_cuda
from .ref import XBAR, xbar_mvm_ref


def pack_planes(x_uint: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, K) unsigned ints in [0, 2^bits) -> (bits, R, G, 4) int32 bit
    masks, G = ceil(K / 128): bit r of word q of [b, i, g] is bit b of
    x[i, 128*g + 32*q + r]; rows past K are zero."""
    r, k = x_uint.shape
    g = -(-k // XBAR)
    x = F.pad(x_uint.to(torch.int64), (0, g * XBAR - k))
    x = x.reshape(1, r, g, 4, 32)
    planes = (x >> torch.arange(bits, device=x.device).reshape(
        bits, 1, 1, 1, 1)) & 1
    words = (planes << torch.arange(32, device=x.device)).sum(-1)
    # [0, 2^32) -> the int32 with the same bits
    return (words - ((words >> 31) << 32)).to(torch.int32)


# weights packed at a time when programming, in whole columns:
# pack_planes' int64 temporaries take about 136 bytes a weight at 8 bits
# (36 GB for a whole 4,096 x 65,536 lm_head, 2.3 GB a block; a block of a
# fixed 8,192 columns would take 32 GB at K = 28,672)
PACK_WEIGHTS = 2 ** 24


def pack_cols(k: int) -> int:
    """Columns of K rows that one block of ``PACK_WEIGHTS`` holds."""
    return max(1, PACK_WEIGHTS // k)


def pack_weight_planes(u_uint: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) offset-encoded weights -> (bits, G, N, 4) int32 bit masks,
    the layout the kernel reads with one 16-byte load per column (1 byte
    per weight at bits = 8); packed :func:`pack_cols` columns at a time."""
    cols = u_uint.t()
    step = pack_cols(cols.shape[1])
    return torch.cat([pack_planes(cols[c:c + step], bits)
                      for c in range(0, cols.shape[0], step)],
                     dim=1).permute(0, 2, 1, 3).contiguous()


def pack_scalars(p: Optional[TRQParams], device) -> torch.Tensor:
    """The kernel's register operand; zeros (unread) when lossless."""
    if p is None:
        return torch.zeros(2, dtype=torch.float32, device=device)
    return register_scalars(p, device)


def xbar_mvm_2d(a_mask: torch.Tensor, w_mask: torch.Tensor,
                p: Optional[TRQParams], *, r_adc: int = 8,
                per_output: bool = False):
    """Masks in, ``(acc, ops total int64, per-output ops or None)`` out;
    ``p=None`` is the lossless native-R_ADC datapath.  The TRQ acts
    unsigned: bit-line sums are never negative, where a signed register
    set quantizes identically."""
    fn = xbar_mvm_ref if route(a_mask) == "cpu" else xbar_mvm_cuda
    regs = {} if p is None else dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m,
                                      nu=p.nu, mode=p.mode)
    return fn(a_mask, w_mask, pack_scalars(p, a_mask.device),
              lossless=p is None,
              r_adc=r_adc, per_output=per_output, **regs)


def xbar_mvm_packed(a_uint: torch.Tensor, w_mask: torch.Tensor,
                    p: Optional[TRQParams], *, k_i: int = 8, k_w: int = 8,
                    r_adc: int = 8, per_output: bool = False):
    """a_uint (M, K) against programmed weight masks: packs the
    activations, runs the sliced MVM and subtracts ``zp * rowsum(a)``.
    Returns ``(out (M, N) f32, ops)``: the per-output (M, N) int32 counts
    with ``per_output``, else the int64 total."""
    acc, total, per = xbar_mvm_2d(pack_planes(a_uint, k_i), w_mask, p,
                                  r_adc=r_adc, per_output=per_output)
    zp = 2 ** (k_w - 1)
    out = acc - zp * a_uint.float().sum(1, keepdim=True)
    return out, (per if per_output else total)


def xbar_mvm(a_uint: torch.Tensor, w_int: torch.Tensor,
             p: Optional[TRQParams] = None, *, k_i: int = 8, k_w: int = 8,
             r_adc: int = 8, per_output: bool = True):
    """Bit-exact sliced-crossbar MVM with a (TRQ-)ADC per bit-line, the
    counterpart of ``repro.kernels.xbar_mvm_pallas``: a_uint (M, K) ints in
    [0, 2^k_i), w_int (K, N) ints in [-2^(k_w-1), 2^(k_w-1)).  Returns
    ``(out (M, N) f32, ops)``, per-output int32 counts by default (the
    int64 total with ``per_output=False``)."""
    u = w_int.to(torch.int32) + 2 ** (k_w - 1)
    return xbar_mvm_packed(a_uint, pack_weight_planes(u, k_w), p, k_i=k_i,
                           k_w=k_w, r_adc=r_adc, per_output=per_output)

"""The two crossbar datapaths of ``repro.pim.crossbar``.

**Bit-exact ISAAC sliced datapath** (paper §II-A, Fig. 1 / Fig. 5): int
weights are offset-encoded to unsigned and stored as ``k_w`` 1-bit cells on
``k_w`` adjacent bit-lines; unsigned inputs are fed by 1-bit DACs as ``k_i``
bit-slices; each (input slice, weight column, 128-row group) produces one
analog bit-line partial sum in ``[0, xbar]`` that the (TRQ-modified) SAR
ADC digitizes — one A/D conversion each — and the S+A module merges them
with the ``2^(b+c)`` significance.  The functions here are the plain tensor
simulation (f32 0/1 plane einsums); the ``bit_exact`` backend runs the same
datapath through the ``xbar_mvm`` kernel.

**Per-group fake-quant datapath**: each 128-row group of the contraction is
one crossbar; its full-precision partial sum is quantized once with a
signed TRQ (paper §III-B: the quantizer is the behavioral abstraction of
A/D conversion at the bit-lines) and the groups are summed.  Partial sums
accumulate in f32 with one cast to the output dtype at the end — the
kernel's discipline.

Operands in bf16 are widened to f32 before the product: the product of two
bf16 values is exact in f32, so this equals the reference's bf16 einsum
with ``preferred_element_type=float32`` (a bf16 ``torch.matmul`` would
round its output to bf16).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.trq import TRQParams, auto_range_delta, trq_ad_ops, trq_quant


@dataclasses.dataclass(frozen=True)
class PimConfig:
    xbar: int = 128          # crossbar rows (= columns) per array
    k_w: int = 8             # weight bit-width
    k_i: int = 8             # input bit-width
    r_adc: int = 8           # native ADC resolution


def _group(x: torch.Tensor, xbar: int, axis: int) -> torch.Tensor:
    """Split a contraction axis into (groups, xbar), zero-padding the tail.
    Returns a view when the axis already divides by ``xbar``."""
    axis = axis % x.ndim
    k = x.shape[axis]
    pad = (-k) % xbar
    if pad:
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
        x = F.pad(x, widths)
    return x.unflatten(axis, (x.shape[axis] // xbar, xbar))


def offset_encode(w_int: torch.Tensor, k_w: int = 8):
    """Signed int weights -> unsigned cell conductances ``u = w + 2^(k_w-1)``.
    Returns ``(u int32, zero_point)``; the MVM correction
    ``a @ w = a @ u - zp * sum(a)`` is applied digitally."""
    zp = 2 ** (k_w - 1)
    return w_int.to(torch.int32) + zp, zp


def bitplanes(x_uint: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Unsigned integer tensor -> stacked 0/1 int32 planes, LSB first."""
    shifts = torch.arange(bits, dtype=torch.int32, device=x_uint.device)
    shifts = shifts.reshape((bits,) + (1,) * x_uint.ndim)
    planes = (x_uint.to(torch.int32).unsqueeze(0) >> shifts) & 1
    return torch.movedim(planes, 0, axis)


def _bl_partial_sums(a_uint: torch.Tensor, u_uint: torch.Tensor,
                     cfg: PimConfig) -> torch.Tensor:
    """All analog bit-line partial sums of an MVM: a_uint (M, K) unsigned
    inputs, u_uint (K, N) offset-encoded weights -> (k_i, k_w, G, M, N) f32
    with integer values in [0, xbar] — exactly what each ADC sees."""
    a_g = _group(bitplanes(a_uint, cfg.k_i), cfg.xbar, 2)     # (k_i,M,G,X)
    u_g = _group(bitplanes(u_uint, cfg.k_w), cfg.xbar, 1)     # (k_w,G,X,N)
    return torch.einsum("imgx,jgxn->ijgmn", a_g.float(), u_g.float())


def _shift_add(y_q: torch.Tensor, cfg: PimConfig) -> torch.Tensor:
    """Digital S+A merge over input-slice and weight-column significance."""
    bi = 2.0 ** torch.arange(cfg.k_i, dtype=torch.float32, device=y_q.device)
    bj = 2.0 ** torch.arange(cfg.k_w, dtype=torch.float32, device=y_q.device)
    return torch.einsum("ijgmn,i,j->mn", y_q, bi, bj)


def weight_planes(w_int: torch.Tensor,
                  cfg: PimConfig = PimConfig()) -> torch.Tensor:
    """Offset-encode + bit-slice + group a signed (..., K, N) weight matrix:
    (..., k_w, G, X, N) 0/1 int8 planes, the cell pattern a crossbar
    programming pass writes."""
    u, _ = offset_encode(w_int, cfg.k_w)
    u_b = bitplanes(u, cfg.k_w, axis=u.ndim - 2)          # (..., k_w, K, N)
    return _group(u_b, cfg.xbar, u_b.ndim - 2).to(torch.int8)


def bit_exact_mvm(a_uint: torch.Tensor, w_int: Optional[torch.Tensor],
                  trq: Optional[TRQParams], cfg: PimConfig = PimConfig(),
                  with_ops: bool = False,
                  u_planes: Optional[torch.Tensor] = None):
    """Full sliced-datapath MVM with per-conversion (TRQ-)ADC quantization.

    a_uint: (M, K) ints in [0, 2^k_i); w_int: (K, N) ints in
    [-2^(k_w-1), 2^(k_w-1)).  ``trq=None`` is the lossless native-R_ADC
    datapath.  Returns the f32 (M, N) integer-valued result and, with
    ``with_ops``, the total A/D operations (int64).  ``u_planes`` (from
    :func:`weight_planes`) replaces the weight-side slicing; ``w_int`` may
    then be None."""
    if u_planes is not None:
        a_g = _group(bitplanes(a_uint, cfg.k_i), cfg.xbar, 2)
        p = torch.einsum("imgx,jgxn->ijgmn", a_g.float(), u_planes.float())
    else:
        u, _ = offset_encode(w_int, cfg.k_w)
        p = _bl_partial_sums(a_uint, u, cfg)
    if trq is None:
        y_q = p
        ops = torch.full(p.shape, cfg.r_adc, dtype=torch.int32,
                         device=p.device)
    else:
        trq = trq.to(p.device)
        y_q, ops = trq_quant(p, trq), trq_ad_ops(p, trq)
    acc = _shift_add(y_q, cfg)
    zp = 2 ** (cfg.k_w - 1)
    out = acc - zp * a_uint.float().sum(1, keepdim=True)
    if with_ops:
        return out, ops.sum(dtype=torch.int64)
    return out


def collect_bl_samples(a_uint: torch.Tensor, w_int: torch.Tensor,
                       cfg: PimConfig = PimConfig()) -> torch.Tensor:
    """Raw (pre-ADC) bit-line partial sums, (k_i, k_w, G, M, N) f32 — the
    calibration samples Algorithm 1 consumes."""
    u, _ = offset_encode(w_int, cfg.k_w)
    return _bl_partial_sums(a_uint, u, cfg)


def group_activations(a: torch.Tensor,
                      cfg: PimConfig = PimConfig()) -> torch.Tensor:
    """(..., K) activations -> (..., G, X) per-crossbar row groups."""
    return _group(a, cfg.xbar, a.ndim - 1)


def group_weights(w: torch.Tensor,
                  cfg: PimConfig = PimConfig()) -> torch.Tensor:
    """(..., K, N) weights -> (..., G, X, N) per-crossbar row groups."""
    return _group(w, cfg.xbar, w.ndim - 2)


def _group_psums(a_g: torch.Tensor, w_g: torch.Tensor) -> torch.Tensor:
    """(..., G, X) x (G, X, N) -> (..., G, N) f32: each [..., g, :] is what
    crossbar ``g``'s ADCs see."""
    return torch.einsum("...gx,gxn->...gn", a_g.float(), w_g.float())


def auto_range_fit_grouped(a_g, w_g, trq: TRQParams, grid) -> TRQParams:
    """:func:`auto_range_fit` on pre-grouped operands.  Stays on the
    device: no host sync.  The maximum is the whole batch's on a mesh that
    splits it."""
    from ..dist.group import global_max
    vmax = global_max(torch.amax(torch.abs(_group_psums(a_g, w_g))))
    return trq.replace(
        delta_r1=auto_range_delta(trq.delta_r1, vmax, grid,
                                  trq.n_r2 + trq.m),
        bias=trq.bias.to(vmax.device))


def auto_range_fit(a, w, trq: TRQParams, grid,
                   cfg: PimConfig = PimConfig()) -> TRQParams:
    """Uncalibrated layers: scale ``delta_r1`` so the coarse range
    2^(n_r2+m)*delta_r1 covers the observed per-group |psum| max."""
    return auto_range_fit_grouped(group_activations(a, cfg),
                                  group_weights(w, cfg), trq, grid)


def fake_quant_mvm_grouped(a_g, w_g, trq: TRQParams, grid, out_dtype,
                           ste: bool = False, auto_range: bool = False,
                           with_ops: bool = False):
    """Grouped-operand core of :func:`fake_quant_mvm`.  With ``ste`` the
    auto-range fit, the quantizer and its op count run outside autograd:
    no gradient reaches them through the straight-through estimator, so
    none of their (..., G, N) intermediates is kept for backward."""
    grid = torch.as_tensor(grid, dtype=torch.float32, device=a_g.device)
    trq = trq.to(a_g.device)
    outside = torch.no_grad if ste else contextlib.nullcontext
    with outside():
        if auto_range:
            trq = auto_range_fit_grouped(a_g, w_g, trq, grid)
    p = _group_psums(a_g, w_g)                          # (..., G, N) f32
    with outside():
        scaled = p / grid
        q = trq_quant(scaled, trq) * grid
    if ste:
        q = p + (q - p.detach())            # q's value, p's gradient
    acc = torch.sum(q, dim=-2).to(out_dtype)            # (..., N)
    if with_ops:
        return acc, trq_ad_ops(scaled, trq).sum(dtype=torch.int64)
    return acc


def fake_quant_mvm(a, w, trq: TRQParams, a_scale, w_scale,
                   cfg: PimConfig = PimConfig(), ste: bool = False,
                   auto_range: bool = False, with_ops: bool = False):
    """Per-group signed-TRQ matmul a (..., K) @ w (K, N) with the partial
    sums expressed in units of ``a_scale * w_scale`` before quantization.
    ``with_ops`` also returns the total A/D operations (int64)."""
    grid = (torch.as_tensor(a_scale, dtype=torch.float32, device=a.device)
            * torch.as_tensor(w_scale, dtype=torch.float32, device=a.device))
    return fake_quant_mvm_grouped(group_activations(a, cfg),
                                  group_weights(w, cfg), trq, grid, a.dtype,
                                  ste=ste, auto_range=auto_range,
                                  with_ops=with_ops)

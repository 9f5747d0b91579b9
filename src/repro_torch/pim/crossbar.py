"""Per-group fake-quant datapath (the fake-quant half of
``repro.pim.crossbar``).

Each 128-row group of the contraction is one crossbar; its full-precision
partial sum is quantized once with a signed TRQ (paper §III-B: the
quantizer is the behavioral abstraction of A/D conversion at the
bit-lines) and the groups are summed.  Partial sums accumulate in f32 with
one cast to the output dtype at the end — the kernel's discipline.

Operands in bf16 are widened to f32 before the product: the product of two
bf16 values is exact in f32, so this equals the reference's bf16 einsum
with ``preferred_element_type=float32`` (a bf16 ``torch.matmul`` would
round its output to bf16).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.trq import TRQParams, trq_ad_ops, trq_quant


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
    device: no host sync."""
    vmax = torch.amax(torch.abs(_group_psums(a_g, w_g)))
    span = vmax / torch.as_tensor(grid, dtype=torch.float32,
                                  device=vmax.device)
    reach = 2.0 ** (trq.n_r2 + trq.m)
    scale = torch.clamp_min(span / reach, 1e-6)
    return trq.replace(delta_r1=trq.delta_r1.to(scale.device) * scale,
                       bias=trq.bias.to(scale.device))


def auto_range_fit(a, w, trq: TRQParams, grid,
                   cfg: PimConfig = PimConfig()) -> TRQParams:
    """Uncalibrated layers: scale ``delta_r1`` so the coarse range
    2^(n_r2+m)*delta_r1 covers the observed per-group |psum| max."""
    return auto_range_fit_grouped(group_activations(a, cfg),
                                  group_weights(w, cfg), trq, grid)


def fake_quant_mvm_grouped(a_g, w_g, trq: TRQParams, grid, out_dtype,
                           ste: bool = False, auto_range: bool = False,
                           with_ops: bool = False):
    """Grouped-operand core of :func:`fake_quant_mvm`."""
    grid = torch.as_tensor(grid, dtype=torch.float32, device=a_g.device)
    trq = trq.to(a_g.device)
    if auto_range:
        trq = auto_range_fit_grouped(a_g, w_g, trq, grid)
    p = _group_psums(a_g, w_g)                          # (..., G, N) f32
    scaled = p / grid
    q = trq_quant(scaled, trq) * grid
    if ste:
        q = p + (q - p).detach()
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

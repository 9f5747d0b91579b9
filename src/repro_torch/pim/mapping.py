"""Layer -> crossbar mapping (paper Fig. 1) and conversion accounting, port
of ``repro.pim.mapping``.

Convolutions are lowered to MVMs by im2col over sliding windows; linear
layers map directly.  A layer that does not fit one crossbar pair is
partitioned over row groups (contraction dim) and column tiles (output
dim); ``LayerMapping`` records the tile counts the energy model needs
(Eq. 4).  ``conv2d_pim`` runs the lowered MVM through the ``xbar_mvm``
kernel (its plain version on a CPU tensor).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.trq import TRQParams
from ..kernels.xbar_mvm import pack_weight_planes, xbar_mvm_packed
from .crossbar import PimConfig, collect_bl_samples


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    name: str
    in_features: int          # contraction length (rows before grouping)
    out_features: int         # logical output columns
    n_mvms: int               # MVMs per inference (tokens or conv positions)
    row_groups: int
    crossbars: int            # physical arrays used (row groups x col tiles)
    k_i: int = 8              # input bit-width (1-bit DAC -> k_i slices)
    k_w: int = 8              # weight bit-width (1-bit cells -> k_w columns)

    @property
    def conversions_per_inference(self) -> int:
        # slices x weight-columns x row-groups x outputs x MVMs  (Eq. 4)
        return self.k_i * self.k_w * self.row_groups * self.out_features \
            * self.n_mvms


def map_linear(name: str, in_features: int, out_features: int,
               n_mvms: int = 1, cfg: PimConfig = PimConfig()) -> LayerMapping:
    groups = math.ceil(in_features / cfg.xbar)
    col_tiles = math.ceil(out_features * cfg.k_w / cfg.xbar)
    return LayerMapping(name, in_features, out_features, n_mvms,
                        groups, groups * col_tiles, k_i=cfg.k_i, k_w=cfg.k_w)


def map_conv2d(name: str, c_in: int, c_out: int, k: int, h_out: int,
               w_out: int, cfg: PimConfig = PimConfig()) -> LayerMapping:
    return map_linear(name, c_in * k * k, c_out, n_mvms=h_out * w_out,
                      cfg=cfg)


# ---------------------------------------------------------------------------
# im2col convolution on the PIM datapath
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, k: int, stride: int = 1, pad: int = 0,
           pad_value=0) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', k*k*C) patches (NHWC), in the
    reference's (di, dj, C) order with C fastest, so that an HWIO weight's
    ``w.reshape(-1, C_out)`` lines up (``F.unfold`` would give (C, di, dj)).

    ``pad_value`` is the activation zero-POINT, not numeric zero: with
    asymmetric input quantization a real-valued 0 encodes as ``zp``, so the
    borders are padded with ``zp`` for the digital correction term to be
    position-independent."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad), value=int(pad_value))
    b, h, w, c = x.shape
    h_out = (h - k) // stride + 1
    w_out = (w - k) // stride + 1
    patches = [x[:, di:di + stride * (h_out - 1) + 1:stride,
                 dj:dj + stride * (w_out - 1) + 1:stride, :]
               for di in range(k) for dj in range(k)]
    return torch.cat(patches, dim=-1)


def conv2d_pim(x_uint: torch.Tensor, w_int: torch.Tensor,
               trq: Optional[TRQParams], stride: int = 1, pad: int = 0,
               pad_value=0, cfg: PimConfig = PimConfig(),
               with_ops: bool = False,
               w_mask: Optional[torch.Tensor] = None):
    """Quantized conv on the bit-exact crossbar through the ``xbar_mvm``
    kernel.  x_uint: (B, H, W, C) unsigned ints; w_int: (k, k, C, C_out)
    signed ints.  ``w_mask`` (``pack_weight_planes`` of the offset-encoded
    ``w_int.reshape(-1, C_out)``) skips programming the weights on every
    call; the outputs are the same.  With ``with_ops`` also the total A/D
    operations (int64)."""
    k = w_int.shape[0]
    cols = im2col(x_uint, k, stride, pad, pad_value)
    b, ho, wo, kk = cols.shape
    a2 = cols.reshape(-1, kk)
    if w_mask is None:
        u = w_int.reshape(-1, w_int.shape[-1]).to(torch.int32) + \
            2 ** (cfg.k_w - 1)
        w_mask = pack_weight_planes(u, cfg.k_w)
    out, ops = xbar_mvm_packed(a2, w_mask, trq, k_i=cfg.k_i, k_w=cfg.k_w,
                               r_adc=cfg.r_adc, per_output=False)
    out = out.reshape(b, ho, wo, -1)
    return (out, ops) if with_ops else out


def conv2d_bl_samples(x_uint: torch.Tensor, w_int: torch.Tensor,
                      stride: int = 1, pad: int = 0, pad_value=0,
                      cfg: PimConfig = PimConfig()) -> torch.Tensor:
    """The conv's raw (pre-ADC) bit-line sums, (k_i, k_w, G, M, N) f32 with
    M = B H' W' (plain torch, as the reference's einsum)."""
    k = w_int.shape[0]
    cols = im2col(x_uint, k, stride, pad, pad_value)
    w2 = w_int.reshape(-1, w_int.shape[-1])
    return collect_bl_samples(cols.reshape(-1, cols.shape[-1]), w2, cfg)

"""TRQ output coding scheme — paper §III-C and the S+A decode of
§III-D-2b, port of ``repro.core.coding``.

Code layout (Fig. 4b): ``[MSB | payload]``
  * MSB = 0 -> value in R1, payload is an ``n_r1``-bit uniform code.
  * MSB = 1 -> value in R2, payload is an ``n_r2``-bit uniform code.

Decode is codebook-free (Eq. 8), in int32 shifts as the reference:
  * MSB = 0 -> grid index = (bias << n_r1) | payload      (offset concat)
  * MSB = 1 -> grid index = payload << m                  (shift by M)
value = grid_index * delta_r1.
"""
from __future__ import annotations

import torch

from .sar_adc import sar_convert_trq
from .trq import TRQParams


def payload_bits(p: TRQParams) -> int:
    return max(p.n_r1, p.n_r2)


def code_bits(p: TRQParams) -> int:
    """Total output-register width (1 range bit + payload)."""
    return 1 + payload_bits(p)


def encode(x, p: TRQParams) -> torch.Tensor:
    """ADC output register contents for each sample of ``x`` (int32)."""
    msb, payload, _ = sar_convert_trq(x, p)
    return (msb << payload_bits(p)) | payload


def split(code: torch.Tensor, p: TRQParams):
    nb = payload_bits(p)
    return code >> nb, code & ((1 << nb) - 1)


def decode_index(code: torch.Tensor, p: TRQParams) -> torch.Tensor:
    """S+A-module decode to an integer index on the fine (delta_r1) grid:
    a conditional left shift and an OR, no multiplier, no codebook
    (paper §III-D-2b)."""
    msb, payload = split(code, p)
    bias_i = torch.as_tensor(p.bias, device=code.device).to(torch.int32)
    fine_idx = (bias_i << p.n_r1) | payload
    coarse_idx = payload << p.m
    return torch.where(msb == 0, fine_idx, coarse_idx)


def decode(code: torch.Tensor, p: TRQParams) -> torch.Tensor:
    return decode_index(code, p).float() * torch.as_tensor(
        p.delta_r1, dtype=torch.float32, device=code.device)


def shift_add(acc: torch.Tensor, code: torch.Tensor, p: TRQParams,
              shift: int) -> torch.Tensor:
    """One cycle of the modified Shift-and-Add module (Fig. 5 (6)): decode
    the compact ADC code, shift by the bit significance of the current
    (input slice, weight column) pair, accumulate."""
    return acc + (decode_index(code, p) << shift)

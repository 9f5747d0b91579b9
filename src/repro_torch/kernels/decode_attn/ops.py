"""Public wrappers of ``decode_attn``: device dispatch.  ``attn_scores``
and ``attn_values`` are the two halves of one-row attention against a
cache (``models.attention.decode_attention``, and a decode step's
cross-attention); between them a rank that holds a share of each head's
dims all-reduces its partial scores.

A CPU (or ``meta``) tensor runs the plain version (``ref.py``), a CUDA
tensor the CUDA kernel (``kernel.py``); nothing falls back from one to
the other.
"""
from __future__ import annotations

import torch

from ..build import route
from .kernel import attn_scores_cuda, attn_values_cuda
from .ref import attn_scores_ref, attn_values_ref


def attn_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, G, hd) f32 queries x (B, S, H, hd) keys -> (B, H, G, 1,
    S) f32 scores."""
    fn = attn_scores_ref if route(q) == "cpu" else attn_scores_cuda
    return fn(q, k)


def attn_values(s: torch.Tensor, v: torch.Tensor, lens=None,
                round_a: bool = False) -> torch.Tensor:
    """(B, H, G, 1, S) f32 scores x (B, S, H, hd) values -> (B, 1, H, G,
    hd) f32: the masked softmax (keys below ``lens``, every key when
    None), its probabilities rounded to v's dtype where ``round_a``, times
    v."""
    fn = attn_values_ref if route(s) == "cpu" else attn_values_cuda
    return fn(s, v, lens, round_a)

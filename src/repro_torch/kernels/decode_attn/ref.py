"""Plain PyTorch versions of the ``decode_attn`` kernel's two entries: the
arithmetic the port's attention ran before the kernel (two batched
products, the mask, the softmax).  The CPU tests use them, and
``chip_smoke.py`` holds the CUDA kernel against them on the card; they
never run on the main path when a card is present."""
from __future__ import annotations

import torch

NEG_INF = -1e30                # models/attention.py's


def attn_scores_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, G, hd) f32; k: (B, S, H, hd).  Returns (B, H, G, 1, S)
    f32: ``q . k`` with k widened to f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q, k.float())


def attn_values_ref(s: torch.Tensor, v: torch.Tensor, lens=None,
                    round_a: bool = False) -> torch.Tensor:
    """s: (B, H, G, 1, S) f32; v: (B, S, H, hd); lens: (B,) valid keys or
    None.  Returns (B, 1, H, G, hd) f32: the softmax over the keys below
    ``lens`` (the others at NEG_INF), rounded to v's dtype where
    ``round_a``, times v widened to f32."""
    if lens is not None:
        mask = torch.arange(s.shape[-1], device=s.device)[None, :] < \
            torch.as_tensor(lens, device=s.device)[:, None]
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    if round_a:
        a = a.to(v.dtype).float()
    return torch.einsum("bkgqs,bskd->bqkgd", a, v.float())

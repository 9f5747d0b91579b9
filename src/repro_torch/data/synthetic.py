"""Deterministic synthetic data (port of ``repro.data.synthetic``).

``TokenStream`` is the LM stream: a Zipf-like unigram draw (the
exponential rank transform) with a ``bigram_frac`` share of the next
tokens taken from a seeded bigram map, so a model can reduce its loss.
Batch ``step`` is a pure function of ``(seed, step)``: a restarted job
regenerates the stream from the checkpoint's step, with no loader state
to save.  The reference draws from ``jax.random``, which numpy cannot
replay, so the stream is the port's own (numpy generators seeded by
``(seed, step)``, never global state); its bigram map is the reference's,
which is numpy already.

``vision_dataset`` is the reference's numpy code as it is: the same seed
gives the same images and labels bit for bit, returned as torch tensors
on the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    batch: int
    seed: int = 0
    bigram_frac: float = 0.7     # fraction of next-tokens from the bigram map

    def _bigram_map(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 7)
        return rng.integers(0, self.vocab_size, self.vocab_size)

    def batch_at(self, step: int, device=None) -> dict:
        """Batch for global step ``step``: ``tokens`` and ``labels`` (the
        tokens shifted by one), (batch, seq_len) int32 on ``device`` (the
        card unless the caller names another)."""
        rng = np.random.default_rng((self.seed, step))
        shape = (self.batch, self.seq_len + 1)
        # zipf-ish unigram draw via the exponential rank transform
        u = rng.uniform(1e-6, 1.0, shape).astype(np.float32)
        ranks = np.floor(np.exp(np.float32(np.log(self.vocab_size)) * u)) - 1
        toks = ranks.astype(np.int64) % self.vocab_size
        # a fraction of the next tokens follow the bigram map instead
        bmap = self._bigram_map()
        use_bigram = rng.uniform(0.0, 1.0, shape) < self.bigram_frac
        seq = toks.copy()
        for t in range(1, shape[1]):
            seq[:, t] = np.where(use_bigram[:, t], bmap[seq[:, t - 1]],
                                 toks[:, t])
        seq = torch.from_numpy(seq.astype(np.int32)).to(
            resolve_device(device))
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def lm_batch(vocab: int, seq: int, batch: int, step: int = 0,
             seed: int = 0, device=None) -> dict:
    """Batch ``step`` of a ``TokenStream(vocab, seq, batch, seed)``."""
    return TokenStream(vocab, seq, batch, seed).batch_at(step, device)


def vision_dataset(n: int, hw: int = 28, ch: int = 1, n_classes: int = 10,
                   seed: int = 0, noise: float = 0.35, split: int = 0,
                   device=None):
    """Fixed random class templates + noise, NHWC f32 images and int32
    labels on ``device`` (the card unless the caller names another).
    Learnable by LeNet-class models in a few hundred steps (Fig. 6).

    ``seed`` fixes the class templates (the task); ``split`` draws disjoint
    instance noise: split=0 for train, split=1 for test."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, 1, (n_classes, hw, hw, ch)).astype(np.float32)
    rng = np.random.default_rng((seed + 1) * 7919 + split)
    # low-pass the templates so conv nets have local structure to exploit
    for _ in range(2):
        templates = (templates
                     + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)) / 5
    labels = rng.integers(0, n_classes, n)
    imgs = templates[labels] + noise * rng.normal(0, 1, (n, hw, hw, ch)
                                                  ).astype(np.float32)
    # shift-augment for variety
    shifts = rng.integers(-2, 3, (n, 2))
    for i in range(n):
        imgs[i] = np.roll(imgs[i], tuple(shifts[i]), (0, 1))
    device = resolve_device(device)
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(labels.astype(np.int32)).to(device))

"""Synthetic image classification for the paper's own evaluation, port of
``repro.data.synthetic.vision_dataset``.

The reference draws with numpy only, so this is a copy of its numpy code:
the same seed gives the same images and labels bit for bit, returned as
torch tensors on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


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

"""Shared utilities of the port's figure benchmarks (a port of
``benchmarks/common.py``): the train-once cache of the paper's CNNs,
timing, CSV emit.

The CNNs train in-repo on the synthetic ``vision_dataset`` with the
reference's loop (mean of logsumexp minus the gold logit, momentum SGD
``m = 0.9 m + g``, ``p -= lr m``, batch indices from
``np.random.default_rng(seed).integers``), written with autograd, from the
port's own seeded init.  ``jax.random`` streams cannot be replayed in
torch, so the trained weights are the port's own, not the reference's.
The cache is ``benchmarks/.cache/{name}_torch.pt``; the reference's
``{name}.pkl`` is never read.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.data.synthetic import vision_dataset
from repro_torch.device import resolve_device
from repro_torch.models.cnn import (LENET5, RESNET20, CNNSpec, apply_cnn,
                                    init_cnn, quantize_cnn)

CACHE = os.path.join(os.path.dirname(__file__), ".cache")
SPECS = {"lenet5": LENET5, "resnet20": RESNET20}
STEPS = {"lenet5": 400, "resnet20": 600}

# dataset difficulty tuned so float accuracy lands ~92% (the ResNet-20/
# CIFAR-10 regime of the paper's Fig. 6): low-bit ADC effects are visible
NOISE = 0.8


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, iters: int = 5, warmup: int = 2,
           device="cuda") -> float:
    """Mean host time of one call in microseconds, the card synchronised
    around every call."""
    for _ in range(warmup):
        fn(*args)
        _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def emit(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


# ---------------------------------------------------------------------------
# trained CNN fixtures (the paper's §V workloads at laptop scale)
# ---------------------------------------------------------------------------

def cnn_loss(params: dict, xb: torch.Tensor, yb: torch.Tensor,
             spec: CNNSpec) -> torch.Tensor:
    """Mean cross-entropy as the reference writes it: logsumexp of the
    logits less the gold logit."""
    logits = apply_cnn(params, xb, spec)
    logz = torch.logsumexp(logits, -1)
    gold = torch.take_along_dim(logits, yb[:, None].long(), -1)[:, 0]
    return torch.mean(logz - gold)


def _train_cnn(spec: CNNSpec, n_train: int = 4096, steps: int = 400,
               lr: float = 3e-3, batch: int = 64, seed: int = 0,
               device=None):
    device = resolve_device(device)
    x, y = vision_dataset(n_train, hw=spec.input_hw, ch=spec.in_ch,
                          n_classes=spec.n_classes, seed=seed, noise=NOISE,
                          device=device)
    params = init_cnn(spec, seed=seed, device=device)
    leaves = [t for p in params.values() for t in p.values()]
    for t in leaves:
        t.requires_grad_(True)
    moms = [torch.zeros_like(t) for t in leaves]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n_train, batch)).to(device)
        loss = cnn_loss(params, x[idx], y[idx], spec)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, m, g in zip(leaves, moms, grads):
                m.mul_(0.9).add_(g)
                t.sub_(lr * m)
    for t in leaves:
        t.requires_grad_(False)
    return params, (x, y)


def accuracy(logit_fn, x: torch.Tensor, y: torch.Tensor,
             batch: int = 256) -> float:
    hits = 0
    for i in range(0, x.shape[0], batch):
        logits = logit_fn(x[i:i + batch])
        hits += int(torch.sum(torch.argmax(logits, -1) == y[i:i + batch]))
    return hits / x.shape[0]


def trained_cnn(name: str = "lenet5", retrain: bool = False, device=None):
    """Returns (spec, float params, quantized model, (x_test, y_test)) on
    ``device`` (the card unless the caller names another).  Cached on disk
    so every figure benchmark shares one trained model; ``retrain`` trains
    anew and rewrites the cache."""
    device = resolve_device(device)
    spec = SPECS[name]
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(CACHE, f"{name}_torch.pt")
    if os.path.exists(path) and not retrain:
        params, xy = torch.load(path, map_location=device)
    else:
        params, xy = _train_cnn(spec, steps=STEPS[name], device=device)
        torch.save((params, xy), path)
    x, _ = xy
    # same class templates (seed), disjoint instances (split=1)
    x_test, y_test = vision_dataset(1024, hw=spec.input_hw, ch=spec.in_ch,
                                    n_classes=spec.n_classes, seed=0,
                                    split=1, noise=NOISE, device=device)
    q = quantize_cnn(params, spec, x[:64])
    return spec, params, q, (x_test, y_test)

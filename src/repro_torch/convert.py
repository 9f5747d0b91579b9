"""Reference weights -> the port's state dict.

``from_jax(params_np, cfg)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (the caller does ``jax.tree.map(np.asarray,
params)``), with the period-stacked leaves of ``params['periods']``, and
returns the state dict the port's model loads: period ``p``, layer ``i``
of the period becomes ``layers.{p * period + i}``; an encoder-decoder's
``enc``/``dec`` stacks (layer axis 0) become ``enc.{i}``/``dec.{i}``.
Layouts are shared (``(K, N)`` weights), so every leaf converts as it is;
``cnn_from_jax`` does the same for the paper's CNNs.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))    # a writable copy


def from_jax(params_np: dict, cfg) -> dict:
    state = {}
    stacks = ("enc", "dec") if cfg.encoder_layers > 0 else ()
    for key, val in params_np.items():
        if key in stacks:
            for path, leaf in _flatten(val):
                for i in range(leaf.shape[0]):
                    state[f"{key}.{i}.{path}"] = _tensor(leaf[i])
            continue
        if key != "periods":
            for path, leaf in _flatten(val, key):
                state[path] = _tensor(leaf)
            continue
        for lkey, ltree in val.items():
            idx = int(lkey.rsplit("_", 1)[1])
            for path, leaf in _flatten(ltree):
                for p in range(cfg.n_periods):
                    depth = p * cfg.period + idx
                    state[f"layers.{depth}.{path}"] = _tensor(leaf[p])
    return state


def cnn_from_jax(params_np: dict, device=None) -> dict:
    """The reference's flat CNN parameters (``repro.models.cnn.init_cnn``:
    ``{"conv0": {"w": HWIO, "b": ...}, "fc7": ..., "proj12": ...}`` as numpy
    arrays) -> the port's (``repro_torch.models.cnn``): the same names and
    layouts, every leaf a tensor on ``device`` (as given: None keeps the
    CPU)."""
    return {name: {k: _tensor(v).to(device) for k, v in leaf.items()}
            for name, leaf in params_np.items()}

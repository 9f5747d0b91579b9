"""Reference weights -> the port's state dict.

``from_jax(params_np, cfg)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (the caller does ``jax.tree.map(np.asarray,
params)``), with the period-stacked leaves of ``params['periods']``, and
returns the state dict the port's ``LM`` loads: period ``p``, layer ``i``
of the period becomes ``layers.{p * period + i}``.  Layouts are shared
(``(K, N)`` weights), so every leaf converts as it is.
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
    for key, val in params_np.items():
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

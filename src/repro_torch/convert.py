"""Reference weights <-> the port's state dict.

``from_jax(params_np, cfg)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (the caller does ``jax.tree.map(np.asarray,
params)``), with the period-stacked leaves of ``params['periods']``, and
returns the state dict the port's model loads: period ``p``, layer ``i``
of the period becomes ``layers.{p * period + i}``; an encoder-decoder's
``enc``/``dec`` stacks (layer axis 0) become ``enc.{i}``/``dec.{i}``.
Layouts are shared (``(K, N)`` weights), so every leaf converts as it is;
``cnn_from_jax`` does the same for the paper's CNNs.

The inverse, ``to_jax(state, cfg)``, stacks the per-layer tensors back
over periods.  Its flat form, :func:`stack_ref` (keys are the reference's
tree paths, ``periods/layer_0/attn/wq/w``), and :func:`ref_groups` (each
reference leaf with the port tensors it stacks) are what the optimizer
and the checkpoints use; ``opt_to_jax``/``opt_from_jax`` map the
optimizer state, which the port already keeps in the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .dist.sharding import whole


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


# ---------------------------------------------------------------------------
# the port -> the reference's layout
# ---------------------------------------------------------------------------

def ref_path(name: str, cfg):
    """A port state-dict name -> (the reference's tree path, the index
    along that leaf's stacked axis or None): ``layers.{d}.attn.wq.w`` ->
    (``periods/layer_{d % period}/attn/wq/w``, ``d // period``);
    ``enc.{i}.*``/``dec.{i}.*`` -> (``enc/*``, ``i``); every other name
    maps as it is."""
    parts = name.split(".")
    if parts[0] == "layers":
        d = int(parts[1])
        return "/".join([f"periods/layer_{d % cfg.period}", *parts[2:]]), \
            d // cfg.period
    if parts[0] in ("enc", "dec") and cfg.encoder_layers > 0:
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def ref_groups(names, cfg) -> dict:
    """{reference path: [port names along its stacked axis]} (one name for
    an unstacked leaf), in the order the reference flattens its tree
    (dict keys sorted at every level)."""
    groups: dict = {}
    for name in names:
        path, idx = ref_path(name, cfg)
        groups.setdefault(path, []).append((idx, name))
    return {path: [n for _, n in sorted(groups[path],
                                        key=lambda t: t[0] or 0)]
            for path in sorted(groups, key=lambda p: tuple(p.split("/")))}


def stacked(path: str, cfg) -> bool:
    """Whether the reference stacks the leaf at ``path`` over layers."""
    head = path.split("/", 1)[0]
    return head == "periods" or (head in ("enc", "dec")
                                 and cfg.encoder_layers > 0)


def stack_ref(state: dict, cfg, device="cpu") -> dict:
    """The port's state -> {reference path: tensor} on ``device`` (the
    host by default: a checkpoint's snapshot), stacked leaves rebuilt from
    their members."""
    out = {}
    for path, names in ref_groups(state, cfg).items():
        members = [whole(state[n].detach()).to(device) for n in names]
        out[path] = torch.stack(members) if stacked(path, cfg) \
            else members[0]
    return out


def unstack_ref(flat: dict, cfg) -> dict:
    """Inverse of :func:`stack_ref`: {reference path: tensor} -> the port's
    state dict (stacked leaves split along their first axis)."""
    state = {}
    for path, t in flat.items():
        head, _, rest = path.partition("/")
        if head == "periods":
            lkey, _, rest = rest.partition("/")
            i = int(lkey.rsplit("_", 1)[1])
            for p in range(t.shape[0]):
                state[f"layers.{p * cfg.period + i}.{rest.replace('/', '.')}"] \
                    = t[p]
        elif stacked(path, cfg):
            for i in range(t.shape[0]):
                state[f"{head}.{i}.{rest.replace('/', '.')}"] = t[i]
        else:
            state[path.replace("/", ".")] = t
    return state


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:           # numpy has no bf16 of its own
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def to_jax(state: dict, cfg) -> dict:
    """The port's state dict -> the reference's parameter tree (nested
    dicts of numpy arrays, bf16 as ``ml_dtypes.bfloat16``), the inverse of
    :func:`from_jax`."""
    return _nest({k: _numpy(v) for k, v in stack_ref(state, cfg).items()})


def opt_to_jax(opt_state: dict) -> dict:
    """The port's optimizer state (``train.optimizer``: ``m`` and ``v``
    keyed by reference path, already stacked) -> the reference's
    ``{"step", "m", "v"}`` tree of numpy arrays."""
    return {"step": _numpy(opt_state["step"]),
            "m": _nest({k: _numpy(v) for k, v in opt_state["m"].items()}),
            "v": _nest({k: {"row": _numpy(v["row"]),
                            "col": _numpy(v["col"])} if isinstance(v, dict)
                        else _numpy(v) for k, v in opt_state["v"].items()})}


def opt_from_jax(opt_np: dict, device=None) -> dict:
    """Inverse of :func:`opt_to_jax`: a factored second moment is the
    reference's ``{"row", "col"}`` dict under its leaf's path."""
    def leaves(tree, prefix=""):
        for key, val in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict) and set(val) != {"row", "col"}:
                yield from leaves(val, path)
            else:
                yield path, val

    def tensor(a):
        if isinstance(a, dict):
            return {k: _tensor(v).to(device) for k, v in a.items()}
        return _tensor(a).to(device)
    return {"step": _tensor(opt_np["step"]).to(device),
            "m": {k: tensor(v) for k, v in leaves(opt_np["m"])},
            "v": {k: tensor(v) for k, v in leaves(opt_np["v"])}}

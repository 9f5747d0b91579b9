"""Fault-tolerant checkpoints in the reference's on-disk format (port of
``repro.ckpt.checkpoint``), so a checkpoint written by either package
restores in the other:

* atomic: written to ``<dir>/tmp.<step>``, the manifest fsynced, then
  renamed to ``step_<%08d>``: a crash mid-write never corrupts the latest
  checkpoint;
* integrity: ``manifest.json`` holds each array's file, shape, dtype name
  and the crc32 of its raw bytes, verified on restore;
* every array is saved as a flat ``uint8`` ``.npy`` of its raw bytes, so
  bf16 survives (numpy has no bf16 of its own);
* async: ``save_async`` snapshots to the host at once and writes in a
  background thread; ``wait_pending`` joins the writers;
* retention: the newest ``keep`` checkpoints stay.

A tree is nested dicts of torch tensors or numpy arrays; its keys are the
"/"-joined paths (a key may itself hold "/", as the reference's flat
trees do).  ``save_train_state``/``restore_train_state`` write and read a
Runtime's parameters and optimizer state under the reference's tree
paths (``params/periods/layer_0/attn/wq/w``, ``opt/m/...``,
``opt/v/.../row``, ``opt/step``), restoring in place.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..dist.sharding import assign, whole

_PENDING: list = []
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
           torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _flatten(tree, prefix: str = "") -> dict:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def _unflatten_into(template, flat: dict, prefix: str = ""):
    out = {}
    for key, val in template.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = _unflatten_into(val, flat, path) \
            if isinstance(val, dict) else flat[path]
    return out


def _host(leaf):
    """A leaf -> (host copy, dtype name, shape): the snapshot."""
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf.detach()).to("cpu", copy=True).contiguous()
        return t, _DTYPES[t.dtype], list(t.shape)
    arr = np.array(leaf)
    return arr, str(arr.dtype), list(arr.shape)


def _raw(host) -> np.ndarray:
    """The flat uint8 view of a host copy's bytes."""
    if isinstance(host, torch.Tensor):
        if host.numel() == 0:
            return np.zeros((0,), np.uint8)
        return host.reshape(-1).view(torch.uint8).numpy()
    if host.size == 0:
        return np.zeros((0,), np.uint8)
    return np.ascontiguousarray(host).reshape(-1).view(np.uint8)


def _snapshot(tree) -> dict:
    return {k: _host(v) for k, v in _flatten(tree).items()}


def _write(ckpt_dir: str, step: int, snap: dict, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}}
    for key, (host, dtype, shape) in snap.items():
        fname = key.replace("/", "__") + ".npy"
        raw = _raw(host)
        np.save(os.path.join(tmp, fname), raw)
        manifest["arrays"][key] = {"file": fname, "shape": shape,
                                   "dtype": dtype,
                                   "crc": zlib.crc32(raw) & 0xffffffff}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` as checkpoint ``step``; returns its directory."""
    return _write(ckpt_dir, step, _snapshot(tree), keep)


def save_async(ckpt_dir: str, step: int, tree, keep: int = 3):
    """Snapshot to the host now, write in a background thread."""
    snap = _snapshot(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, snap, keep),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template=None, step: Optional[int] = None,
            verify: bool = True, device=None):
    """Load checkpoint ``step`` (default: the latest) as CPU tensors (or on
    ``device``).  With a ``template`` (nested dicts; only its structure is
    read) the keys must be the template's, and the result takes its
    structure; without one the result is the flat ``{path: tensor}``.
    ``verify`` raises ``IOError`` on a crc32 mismatch."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if template is not None and \
            set(manifest["arrays"]) != set(_flatten(template)):
        raise KeyError("checkpoint keys do not match template structure")
    flat = {}
    for key, meta in manifest["arrays"].items():
        raw = np.load(os.path.join(d, meta["file"]))
        if verify and zlib.crc32(np.ascontiguousarray(raw)) & 0xffffffff \
                != meta["crc"]:
            raise IOError(f"checksum mismatch for {key} in {d}")
        dtype = _BY_NAME[meta["dtype"]]
        t = torch.from_numpy(raw).view(dtype) if raw.size else \
            torch.empty(0, dtype=dtype)
        flat[key] = t.reshape(meta["shape"]).to(device)
    return flat if template is None else _unflatten_into(template, flat)


def _gc(ckpt_dir: str, keep: int) -> None:
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_"))
    for n in names[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)


# ---------------------------------------------------------------------------
# a Runtime's training state under the reference's tree paths
# ---------------------------------------------------------------------------

def save_train_state(ckpt_dir: str, step: int, params: dict,
                     opt_state: dict, cfg, keep: int = 3,
                     background: bool = False):
    """Checkpoint ``params`` and ``opt_state`` at ``step`` as the
    reference's ``Trainer`` does, ``{"params": ..., "opt": ...}`` in its
    layout (stacked leaves built on the host); ``background`` writes as
    :func:`save_async`."""
    tree = {"params": convert.stack_ref(params, cfg), "opt": opt_state}
    return (save_async if background else save)(ckpt_dir, step, tree, keep)


def restore_train_state(ckpt_dir: str, params: dict, opt_state: dict, cfg,
                        step: Optional[int] = None, verify: bool = True):
    """Read a checkpoint written by either package into ``params`` and
    ``opt_state`` in place (shapes and dtypes must match); returns them and
    the step."""
    step = step if step is not None else latest_step(ckpt_dir)
    template = {"params": dict.fromkeys(
        convert.ref_groups(params, cfg)), "opt": opt_state}
    tree = restore(ckpt_dir, template, step=step, verify=verify)

    def put(dst: torch.Tensor, src: torch.Tensor, key: str):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"{key}: checkpoint holds {src.dtype} "
                             f"{tuple(src.shape)}, the state "
                             f"{dst.dtype} {tuple(dst.shape)}")
        with torch.no_grad():
            assign(dst, src.to(dst.device))
    for name, t in convert.unstack_ref(tree["params"], cfg).items():
        put(params[name], t, f"params/{name}")
    flat_opt = _flatten(tree["opt"])
    for key, dst in _flatten(opt_state).items():
        put(dst, flat_opt[key], f"opt/{key}")
    return params, opt_state, step

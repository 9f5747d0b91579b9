"""Production and host meshes (port of ``repro.launch.mesh``).

Functions, so importing this module touches no process group.  Each mesh
spans ranks ``0 .. size-1`` of the default process group, which the
caller brings up (``dist.group.init_local``); without one,
:func:`make_production_mesh` starts a ``fake`` group of the mesh's size
(one host process stands in for every rank: the dry run) and
:func:`make_host_mesh` a one-rank group on this host.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..dist.group import destroy, init_local


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; ``multi_pod`` adds the 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        init_local("fake", world=512 if multi_pod else 256)
    return _mesh("cpu", shape, names)


def make_host_mesh(device=None):
    """``(n, 1)`` over the ranks of the process group: one rank a card (a
    one-rank NCCL group on one card: ``(1, 1)``), or CPU ranks (gloo) when
    ``device="cpu"``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_local("nccl" if dev.type == "cuda" else "gloo")
    return _mesh(dev.type, (dist.get_world_size(), 1), ("data", "model"))


def sharding_mesh(mesh):
    """``mesh`` when it spans more than one rank, else None: a one-rank
    mesh shards nothing, and placing on it would only add a gather hook
    to every module of every forward (the mesh-less path gives the same
    numbers, bitwise)."""
    return mesh if mesh.size() > 1 else None


@contextlib.contextmanager
def host_mesh(device=None):
    """:func:`make_host_mesh` for the dynamic extent; a process group it had
    to start is destroyed at the end."""
    started = not dist.is_initialized()
    try:
        yield make_host_mesh(device)
    finally:
        if started:
            destroy()

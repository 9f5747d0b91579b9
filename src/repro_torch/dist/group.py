"""Process groups and the batch split of a meshed run.

:func:`init_local` brings up the default process group from a store on
this host (a ``FileStore`` for several processes, a ``HashStore`` for one,
the testing ``fake`` store for a simulated world), never a TCP rendezvous
that could wait on a network.

A meshed ``Runtime`` runs one program on every rank: each entry point gets
the whole batch, the ranks of the data axes (``('pod', 'data')``) each run
their share of its rows (:func:`batch_share`) and the model axis runs the
same rows on every rank.  While a forward holds its share
(:func:`split_batch`), every quantity the single-device run takes over the
whole batch is reduced over the data axes: the dynamic max-abs scales and
the auto-range maximum (:func:`global_max`) and the A/D operation count
(:func:`global_sum`, once over the data axes, never again over the model
axis); outputs come back whole (:func:`gather_rows`).
"""
from __future__ import annotations

import contextlib
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from . import sharding


def init_local(backend: str, world: int = 1, rank: int = 0,
               store_path: Optional[str] = None,
               timeout_s: float = 60.0) -> None:
    """Initialise the default process group of ``world`` ranks on this
    host: ``backend`` ``nccl``, ``gloo`` or ``fake``; ``store_path`` names
    the ``FileStore`` that several processes share (one process needs
    none).  Setup that takes longer than ``timeout_s`` raises."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already up")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    elif store_path is not None:
        store = dist.FileStore(store_path, world)
    elif world == 1:
        store = dist.HashStore()
    else:
        raise ValueError(f"{world} processes need a shared store_path")
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def dp_axes(mesh) -> tuple:
    """The data axes of ``mesh`` with more than one rank, outer first."""
    return tuple(a for a in sharding._DP_AXES
                 if a in sharding.axis_names(mesh)
                 and sharding.axis_size(mesh, a) > 1)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= sharding.axis_size(mesh, a)
    return n


def dp_index(mesh) -> int:
    """This rank's position along the data axes (outer axis major)."""
    i = 0
    for a in dp_axes(mesh):
        i = i * sharding.axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def batch_share(mesh, batch: int) -> Optional[slice]:
    """The rows of a ``batch``-row input this rank runs, or None when the
    batch does not split evenly over the data axes (every rank then runs
    all rows, as the reference replicates an indivisible batch dim)."""
    if mesh is None:
        return None
    n = dp_size(mesh)
    if n == 1 or batch % n or batch < n:
        return None
    per = batch // n
    i = dp_index(mesh)
    return slice(i * per, (i + 1) * per)


@contextlib.contextmanager
def split_batch(on: bool = True):
    """Mark the dynamic extent as running this rank's share of the rows."""
    prev = sharding._ACTIVE["split"]
    sharding._ACTIVE["split"] = on
    try:
        yield
    finally:
        sharding._ACTIVE["split"] = prev


def batch_is_split() -> bool:
    """Whether the running forward holds only this rank's rows."""
    return _split_mesh() is not None and dp_size(_split_mesh()) > 1


def _split_mesh():
    mesh = sharding._ACTIVE["mesh"]
    return mesh if sharding._ACTIVE["split"] and mesh is not None else None


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    mesh = _split_mesh()
    if mesh is None:
        return t
    out = t.detach().clone()
    for a in dp_axes(mesh):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def global_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a maximum over this rank's rows) maximised over the data
    axes while the batch is split; as it is otherwise."""
    return _reduce(t, dist.ReduceOp.MAX)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axes while the batch is split."""
    return _reduce(t, dist.ReduceOp.SUM)


def gather_rows(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Concatenate every data rank's ``t`` along ``dim``, in rank order."""
    for a in reversed(dp_axes(mesh)):         # inner axis first
        parts = [torch.empty_like(t) for _ in range(
            sharding.axis_size(mesh, a))]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts, dim)
    return t

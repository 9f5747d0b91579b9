"""Process groups and the row split of a meshed run.

:func:`init_local` brings up the default process group from a store on
this host (a ``FileStore`` for several processes, a ``HashStore`` for one,
the testing ``fake`` store for a simulated world), never a TCP rendezvous
that could wait on a network.

A meshed ``Runtime`` runs one program on every rank: each entry point gets
the whole batch, and each rank runs its block of the rows.  The data axes
(``('pod', 'data')``) split the batch (:func:`batch_share`); under the
reference's context-parallel layout (``parallelism="fsdp_cp"``) the model
axis splits the sequence (:func:`seq_share`), and attention gathers the
keys and values whole (:func:`gather_seq`).  A length that does not
divide runs whole on every rank of the axis, as the reference replicates
an indivisible dim.  While a forward holds its block
(:func:`split_rows`), every quantity the single-device run takes over
all rows is reduced over the split axes: the dynamic max-abs scales and
the auto-range maximum (:func:`global_max`), the A/D operation count
(:func:`global_sum`, once) and the MoE Switch loss's two means
(``models.moe.switch_loss``); outputs come back whole
(:func:`gather_rows`), but for a decode step's K/V share where the
caller keeps it (``Runtime.decode(kv_share=True)``).
A section that every model rank runs on the same rows (:func:`replicated`:
a patch frontend's projection, the serving logits) reduces over the data
axes only, and its A/D count is kept by model rank 0 (:func:`counts_here`).

At decode the model axis splits the attention heads instead, the
reference's cache layout (:func:`head_axes`): a rank keeps and attends
its share of the KV cache, whole KV heads when they divide the axis, else
a block of every head's dims (:class:`HeadShare`, installed for a forward
by :func:`split_heads`).  The projections still run whole on every model
rank; attention gathers its output's heads before ``wo``, and a head-dim
share all-reduces its partial scores.
"""
from __future__ import annotations

import contextlib
import datetime
from typing import NamedTuple, Optional

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


def seq_size(mesh) -> int:
    """The ranks of the model axis (1 without one)."""
    if mesh is None or "model" not in sharding.axis_names(mesh):
        return 1
    return sharding.axis_size(mesh, "model")


def seq_share(mesh, cfg, length: int) -> Optional[slice]:
    """This rank's block of a ``length``-row sequence on ``'model'``
    (``.start`` is its absolute offset), or None: the layout is not
    ``fsdp_cp``, the axis has one rank, or it does not divide ``length``
    (every rank then runs all rows)."""
    n = seq_size(mesh)
    if n == 1 or cfg.parallelism != "fsdp_cp" or length % n:
        return None
    per = length // n
    i = mesh.get_local_rank("model")
    return slice(i * per, (i + 1) * per)


@contextlib.contextmanager
def split_rows(axes: tuple = ()):
    """Mark the dynamic extent as running this rank's block of the rows,
    split over the mesh ``axes`` (data axes for the batch, ``'model'``
    for the sequence; empty for none)."""
    prev = sharding._ACTIVE["split"], sharding._ACTIVE["replicated"]
    sharding._ACTIVE["split"] = tuple(axes)
    sharding._ACTIVE["replicated"] = False
    try:
        yield
    finally:
        sharding._ACTIVE["split"], sharding._ACTIVE["replicated"] = prev


@contextlib.contextmanager
def replicated():
    """Mark a section that every model rank runs on the same rows: its
    reductions skip ``'model'`` and its A/D count is model rank 0's."""
    prev = sharding._ACTIVE["replicated"]
    sharding._ACTIVE["replicated"] = True
    try:
        yield
    finally:
        sharding._ACTIVE["replicated"] = prev


def _reduce_axes() -> tuple:
    """The mesh axes that hold distinct rows of the running section."""
    mesh = sharding._ACTIVE["mesh"]
    if mesh is None:
        return ()
    axes = sharding._ACTIVE["split"]
    if sharding._ACTIVE["replicated"]:
        axes = tuple(a for a in axes if a != "model")
    return tuple(a for a in axes if sharding.axis_size(mesh, a) > 1)


def rows_split() -> bool:
    """Whether the running section holds only this rank's rows."""
    return bool(_reduce_axes())


def split_ranks() -> int:
    """The ranks over which the running section's rows are split."""
    n = 1
    for a in _reduce_axes():
        n *= sharding.axis_size(sharding._ACTIVE["mesh"], a)
    return n


def gather_tokens(t: torch.Tensor) -> torch.Tensor:
    """A (rows, seq, ...) tensor of this rank's block of the tokens ->
    the whole (B, S, ...) one device holds, on every rank."""
    mesh, axes = sharding._ACTIVE["mesh"], _reduce_axes()
    if "model" in axes:
        t = gather_rows(t, 1, mesh, ("model",))
    data = tuple(a for a in axes if a != "model")
    return gather_rows(t, 0, mesh, data) if data else t


def seq_is_split() -> bool:
    """Whether the running forward holds only this rank's block of the
    sequence (attention then gathers the keys and values)."""
    mesh = sharding._ACTIVE["mesh"]
    return mesh is not None and "model" in sharding._ACTIVE["split"] and \
        seq_size(mesh) > 1


def seq_offset(rows: int) -> int:
    """The absolute position of this rank's first row of the sequence,
    each rank holding ``rows`` of it (0 while it is not split)."""
    if not seq_is_split():
        return 0
    return sharding._ACTIVE["mesh"].get_local_rank("model") * rows


def counts_here() -> bool:
    """Whether this rank adds the running section's A/D operations to the
    forward's count: always, but in a :func:`replicated` section of a
    sequence-split forward only on model rank 0."""
    return not (sharding._ACTIVE["replicated"] and seq_is_split()
                and sharding._ACTIVE["mesh"].get_local_rank("model") != 0)


def reduce_over_split(t: torch.Tensor, op) -> torch.Tensor:
    """All-reduce ``t`` in place over the axes that split the running
    section's rows; returns it."""
    mesh = sharding._ACTIVE["mesh"]
    for a in _reduce_axes():
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def cell_reducer():
    """K1's split launch's cell reduction (an in-place MAX over the axes
    that split the rows), or None while one call holds every row."""
    if not _reduce_axes():
        return None
    return lambda cells: reduce_over_split(cells, dist.ReduceOp.MAX)


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    if not _reduce_axes():
        return t
    return reduce_over_split(t.detach().clone(), op)


def global_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a maximum over this rank's rows) maximised over the axes
    that split the rows; as it is otherwise."""
    return _reduce(t, dist.ReduceOp.MAX)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the axes that split the rows."""
    return _reduce(t, dist.ReduceOp.SUM)


def gather_rows(t: torch.Tensor, dim: int, mesh, axes=None) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` over the mesh ``axes``
    (default: the data axes), outer axis major, in rank order."""
    axes = dp_axes(mesh) if axes is None else axes
    for a in reversed(axes):                  # inner axis first
        parts = [torch.empty_like(t) for _ in range(
            sharding.axis_size(mesh, a))]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts, dim)
    return t


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` over ``'model'``; the backward sums the
    ranks' gradients of the whole and keeps this rank's block."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh, ctx.rows = dim, mesh, t.shape[dim]
        return gather_rows(t, dim, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.get_group("model"))
        i = ctx.mesh.get_local_rank("model")
        return g.narrow(ctx.dim, i * ctx.rows, ctx.rows), None, None


def gather_seq(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's block of ``t`` concatenated along ``dim`` (the
    whole sequence) while the sequence is split; ``t`` otherwise."""
    if not seq_is_split():
        return t
    return _GatherSeq.apply(t, dim, sharding._ACTIVE["mesh"])


# ---------------------------------------------------------------------------
# the head split of a decode step
# ---------------------------------------------------------------------------

def head_axes(mesh, cfg) -> tuple:
    """(KV-head entry, head-dim entry) of an attention cache leaf, the
    reference's rule: 'model' on the KV heads when they divide it, else on
    the head dim when that divides it, else on neither."""
    names = sharding.axis_names(mesh)
    if "model" not in names:
        return None, None
    n_m = sharding.axis_size(mesh, "model")
    if cfg.n_kv_heads % n_m == 0:
        return "model", None
    if cfg.hd % n_m == 0:
        return None, "model"
    return None, None


class HeadShare(NamedTuple):
    """This rank's share of the attention heads at decode: ``kv`` whole KV
    heads (each with its G query heads) or a block of every head's dims,
    the ``index``-th of ``ranks`` on ``mesh``'s 'model' axis."""
    kv: bool
    ranks: int
    index: int
    mesh: object

    def _cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.ranks
        return t.narrow(dim, self.index * n, n)

    def keys(self, t: torch.Tensor) -> torch.Tensor:
        """A (..., KV, hd) key or value tensor -> this rank's share."""
        return self._cut(t, -2 if self.kv else -1)

    def queries(self, qg: torch.Tensor) -> torch.Tensor:
        """Grouped (..., KV, G, hd) queries -> this rank's share."""
        return self._cut(qg, -3 if self.kv else -1)

    def scores(self, s: torch.Tensor) -> torch.Tensor:
        """Scores of the share -> the whole heads' (a head-dim share's are
        partial sums over the dims: one all-reduce over 'model')."""
        if self.kv:
            return s
        s = s.contiguous()
        dist.all_reduce(s, group=self.mesh.get_group("model"))
        return s

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """The share's (B, S, KV, G, hd) output -> every head's, gathered
        over 'model' in head order."""
        return gather_rows(o, o.ndim - 3 if self.kv else o.ndim - 1,
                           self.mesh, ("model",))


def head_share(mesh, cfg) -> Optional[HeadShare]:
    """This rank's :class:`HeadShare` of ``cfg``'s attention on ``mesh``
    by :func:`head_axes`, or None: no mesh, one model rank, or neither
    the KV heads nor the head dim divides the axis (every rank then holds
    whole heads, as the reference replicates)."""
    if mesh is None or seq_size(mesh) == 1:
        return None
    kv_ax, hd_ax = head_axes(mesh, cfg)
    if kv_ax is None and hd_ax is None:
        return None
    return HeadShare(kv_ax is not None, seq_size(mesh),
                     mesh.get_local_rank("model"), mesh)


@contextlib.contextmanager
def split_heads(share: Optional[HeadShare]):
    """Mark the dynamic extent as a decode step whose attention holds
    ``share`` of the heads (None: whole heads)."""
    prev = sharding._ACTIVE["heads"]
    sharding._ACTIVE["heads"] = share
    try:
        yield
    finally:
        sharding._ACTIVE["heads"] = prev


def heads_held() -> Optional[HeadShare]:
    """The running decode step's :class:`HeadShare`, or None."""
    return sharding._ACTIVE["heads"]

"""Paged KV block pool (port of ``repro.serve.kvcache.PagedKVCache``).

The cache leaves that scale with the cache length (attention ``k``/``v``,
shaped ``(La, B, S, KV, hd)``, and an encoder-decoder's cross-KV ``xk``/
``xv``) are backed by pools shaped ``(num_blocks, La, block_size, KV,
hd)``: a page holds ``block_size`` rows of one request across all layers,
and requests own per-slot block tables of page ids; one table indexes every
pool.  The cross-KV leaves are static (``static``): written at prefill and
never by a decode step's write-back.  The rest of the cache is O(1) per
request and stays slot-resident (the "state" part): the ``len``/``len0``
counters, and the recurrent state (rwkv's ``s``/``x_prev``, mamba's
``h``/``conv``).  A model with no attention layer (rwkv6) has no paged
leaf (``specs`` is empty): no pools, no pages, no block writes; a hybrid
(jamba) has pools for its attention layers only.  The leaves come from
the model's own cache functions (``models.registry.model_module``).

Page 0 is permanently zero: block tables are padded with it, so the gather
materializes exact zeros for unallocated tail pages — what makes paged
decode bitwise-identical to the dense slot engine.  Pages carry refcounts
and a free list; full prompt blocks are hash-consed by
``(bucket, sha1(padded_tokens[:k*block_size]))`` and shared copy-on-write,
with LRU eviction of cached prefixes when the pool runs dry.

Under a mesh (``pool_pspecs``) a pool is a DTensor: the page axis stays
replicated, because the host allocates pages and every data row must
address them, and the head dims split over ``'model'`` as the dense
``kv_pspec`` does, so a page costs each rank its share of the heads.  A
decode step reads and writes only that share: :meth:`PagedKVCache.
assemble` gathers pages from the rank's own block, with no collective,
and the step's new cache is a share already (``dist.group.HeadShare``).
A data rank writes back only its own rows' blocks, the rows it decodes;
every other page (a prefill's, a copy-on-write copy, a zeroed one) is
written alike on every rank.  A prefill still yields whole heads, cut to
the share where it is written; a continued prefill gathers the whole
heads of its warm pages once.  ``kv_pspec``/``cache_pspecs`` are the
dense cache's specs, the reference's policy.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from ..dist import group, sharding
from ..dist.sharding import P, PartitionSpec
from ..models.registry import model_module

ZERO_PAGE = 0               # permanently zero; backs unallocated table slots


def _axis_size(mesh, axes) -> int:
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = sharding.axis_names(mesh)
    n = 1
    for a in axes:
        if a in names:
            n *= sharding.axis_size(mesh, a)
    return n


def _dp(mesh) -> tuple:
    return tuple(a for a in sharding._DP_AXES
                 if a in sharding.axis_names(mesh))


def _batch_entry(mesh, batch: int):
    dp = _dp(mesh)
    n_dp = _axis_size(mesh, dp)
    return dp if (batch % max(n_dp, 1) == 0 and batch >= n_dp) else None


def kv_pspec(mesh, cfg, batch: int, stacked: bool = True) -> PartitionSpec:
    """Spec of a (B, S, KV, hd) cache leaf (with a leading layer-stack dim
    when ``stacked``): batch over the data axes when it divides them, else
    the sequence over 'data'; heads as :func:`dist.group.head_axes`."""
    dp = _dp(mesh)
    n_dp = _axis_size(mesh, dp)
    batch_ok = batch % n_dp == 0 if n_dp > 1 else True
    if batch_ok and batch >= n_dp:
        b_ax, s_ax = dp, None
    else:
        b_ax = None
        s_ax = "data" if "data" in sharding.axis_names(mesh) else None
    kv_ax, hd_ax = group.head_axes(mesh, cfg)
    spec = (b_ax, s_ax, kv_ax, hd_ax)
    return P(*((None,) + spec)) if stacked else P(*spec)


def cache_pspecs(mesh, cfg, cache: dict, batch: int) -> dict:
    """{leaf: spec} of a cache from the model's ``init_cache``: K/V (and
    an encoder-decoder's cross-K/V ``xk``/``xv``) by :func:`kv_pspec`,
    the batch of every other leaf over the data axes, the recurrent
    state's channels over 'model'.  A meshed decode step holds and
    attends the K/V share these specs place (its rows, its heads) and
    gathers none of it; two entries have no counterpart in the port yet
    (:func:`step_pspecs`)."""
    kv = kv_pspec(mesh, cfg, batch)
    b_ax = _batch_entry(mesh, batch)
    model = "model" if "model" in sharding.axis_names(mesh) else None
    out = {}
    for key, leaf in cache.items():
        nd = leaf.ndim
        spec = [None] * nd
        if key in ("k", "v", "xk", "xv"):
            out[key] = kv if nd == 5 else P(*kv[1:]) if nd == 4 else P()
            continue
        if key in ("len", "len0"):
            spec[-1] = b_ax
        elif key == "h":              # mamba state (L, B, di, ds)
            spec[-3], spec[-2] = b_ax, model
        elif key == "conv":           # (L, B, dc-1, di)
            spec[-3], spec[-1] = b_ax, model
        elif key == "s":              # rwkv state (L, B, H, hs, hs)
            spec[-4], spec[-3] = b_ax, model
        elif key == "x_prev":         # (L, B, 1, D)
            spec[-3] = b_ax
        out[key] = P(*spec)
    return out


def step_pspecs(mesh, cfg, cache: dict, batch: int) -> dict:
    """{leaf: spec} of the cache a meshed decode step of the port takes
    and returns: :func:`cache_pspecs` without the entries the port does
    not place yet, a batch-1 cache's sequence over 'data' (its
    flash-decode combine) and the recurrent state's channels over
    'model'; so the rows over the data axes and the K/V heads (or head
    dims) over 'model'."""
    specs = cache_pspecs(mesh, cfg, cache, batch)
    out = {}
    for key, spec in specs.items():
        if key in ("k", "v", "xk", "xv") and len(spec) >= 4:
            spec = P(*(spec[:-3] + (None,) + spec[-2:]))
        elif key not in ("k", "v", "xk", "xv"):
            spec = P(*(None if e == "model" else e for e in spec))
        out[key] = spec
    return out


def pool_pspecs(mesh, cfg, pools: dict) -> dict:
    """{pool: spec} of ``PagedKVCache.pools`` (each ``(num_blocks, L,
    block_size, KV, hd)``): the page axis replicated, the head dims as
    :func:`kv_pspec` splits them.  A decode step gathers pages from the
    rank's own block and attends that share: no collective reads a
    pool."""
    kv_ax, hd_ax = group.head_axes(mesh, cfg)
    out = {}
    for key, leaf in pools.items():
        spec = [None] * leaf.ndim
        if leaf.ndim >= 4:
            spec[-2], spec[-1] = kv_ax, hd_ax
        out[key] = P(*spec)
    return out




@dataclasses.dataclass
class _PrefixNode:
    pages: tuple                # page ids for blocks [0, k)
    bucket: int


class PagedKVCache:
    """Block pool + page bookkeeping for one (model, max_batch, max_len)."""

    def __init__(self, cfg, max_batch: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 dtype=torch.bfloat16, device=None):
        if max_len % block_size:
            raise ValueError(f"max_len={max_len} must divide by "
                             f"block_size={block_size}")
        if block_size & (block_size - 1):
            raise ValueError(f"block_size={block_size} must be a power of 2")
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.pages_per_slot = max_len // block_size
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        if num_blocks is None:
            # residency for every slot + prefix-cache headroom + zero page
            num_blocks = 1 + (max_batch + 2) * self.pages_per_slot
        self.num_blocks = num_blocks
        self._model = model_module(cfg)
        # the paged leaves the model has, and those written at prefill only
        self.specs = self._model.paged_keys(cfg)
        self.static = self._model.STATIC_KEYS
        probe = self._model.init_cache(cfg, 1, block_size, dtype, "meta")
        self.pools = {k: torch.zeros(
            (num_blocks, probe[k].shape[0]) + probe[k].shape[2:],
            dtype=dtype, device=device) for k in self.specs}
        self.refcount = np.zeros((num_blocks,), np.int64)
        self.refcount[ZERO_PAGE] = 1            # never allocatable
        self.free: list = list(range(1, num_blocks))
        self.prefix_index: "collections.OrderedDict[tuple, _PrefixNode]" = \
            collections.OrderedDict()
        self.stats = {"reused_blocks": 0, "reused_tokens": 0,
                      "prefix_evictions": 0, "cow_copies": 0,
                      "peak_pages_in_use": 0}

    # -- pool <-> dense ------------------------------------------------------

    def make_state(self, batch: int, fill_len: Optional[int] = None) -> dict:
        """Zeroed slot-resident state (every leaf but the paged ones);
        ``fill_len`` seeds the ``len`` counters for a continued prefill
        over a reused prefix."""
        state = self._model.init_state(self.cfg, batch, self.dtype,
                                       self.device)
        if fill_len:
            state["len"].fill_(fill_len)
        return state

    def state_only(self, cache: dict) -> dict:
        """The slot-resident part of a cache."""
        return {k: v for k, v in cache.items() if k not in self.specs}

    def assemble(self, state: dict, tables: np.ndarray,
                 whole: bool = False) -> dict:
        """The dense cache for a decode / continued-prefill step, gathered
        through ``tables`` (B, n_pages), padded with ZERO_PAGE: on a mesh
        this rank's share of the heads (a decode step's, no collective),
        or with ``whole`` every head (a continued prefill's warm pages,
        gathered over 'model')."""
        t = torch.as_tensor(tables, dtype=torch.long, device=self.device)
        out = dict(state)
        for key, pool in self.pools.items():
            g = sharding.local(pool)[t]          # (B, np, L, bs, KV, hd)
            if whole and pool is not sharding.local(pool):
                g = self._whole_heads(pool, g)
            b, n_pages, n_l, bs = g.shape[:4]
            out[key] = g.permute(2, 0, 1, 3, 4, 5).reshape(
                n_l, b, n_pages * bs, *g.shape[4:])
        return out

    def place(self, mesh) -> None:
        """Place the pools on ``mesh`` by :func:`pool_pspecs`."""
        specs = pool_pspecs(mesh, self.cfg, self.pools)
        self.pools = {k: sharding.place(v, mesh, specs[k])
                      for k, v in self.pools.items()}

    @staticmethod
    def _whole_heads(pool, g: torch.Tensor) -> torch.Tensor:
        """Pages gathered from a pool's local block -> their whole heads
        (the gathered pages have one more leading dim than the pool)."""
        from torch.distributed.tensor import DTensor, Shard
        pl = [Shard(p.dim + 1) if p.is_shard() else p
              for p in pool.placements]
        return DTensor.from_local(g, pool.device_mesh, pl,
                                  run_check=False).full_tensor()

    @staticmethod
    def _own_heads(pool, data: torch.Tensor) -> torch.Tensor:
        """Whole-head blocks -> this rank's share of their heads."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(data, pool.device_mesh, pool.placements,
                                 src_data_rank=None).to_local()

    def write_blocks(self, cache: dict, slots, blks, pages,
                     skip_static: bool = False) -> None:
        """Scatter the (slot, blk) windows of a dense cache into pages;
        ``skip_static`` leaves the static leaves' pages as they are (a
        decode step's write-back).  On a mesh a cache with whole heads (a
        prefill's) is cut to this rank's share here; a decode step's is
        the share already."""
        if not len(pages):
            return
        dev = self.device
        s = torch.as_tensor(np.asarray(slots), dtype=torch.long, device=dev)
        b = torch.as_tensor(np.asarray(blks), dtype=torch.long, device=dev)
        p = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=dev)
        for key, pool in self.pools.items():
            if skip_static and key in self.static:
                continue
            leaf = cache[key].unflatten(2, (-1, self.block_size))
            data = leaf[:, s, b].transpose(0, 1)   # (A, L, bs, KV, hd)
            local = sharding.local(pool)
            if data.shape[-2:] != local.shape[-2:]:
                data = self._own_heads(pool, data)
            local[p] = data.to(pool.dtype)
        self._track_peak()

    def _zero_pages(self, pages) -> None:
        p = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for pool in self.pools.values():
            sharding.local(pool)[p] = 0

    # -- page bookkeeping ------------------------------------------------------

    def _track_peak(self):
        in_use = int((self.refcount > 0).sum()) - 1
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], in_use)

    def alloc_pages(self, n: int) -> list:
        """Allocate ``n`` zeroed pages, LRU-evicting cached prefixes when
        the free list runs dry."""
        while len(self.free) < n:
            if not self._evict_one():
                raise RuntimeError(
                    f"KV block pool exhausted ({self.num_blocks} pages, "
                    f"{n - len(self.free)} short) — raise num_blocks or "
                    f"lower max_batch/max_len")
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.refcount[p] += 1
        if pages:
            self._zero_pages(pages)
        self._track_peak()
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            self.refcount[p] += 1

    def release(self, pages) -> None:
        for p in pages:
            if self.refcount[p] <= 0:
                raise RuntimeError(f"page {p} over-released")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free.append(p)

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix node; True if one was freed."""
        if not self.prefix_index:
            return False
        _, node = self.prefix_index.popitem(last=False)
        self.release(node.pages)
        self.stats["prefix_evictions"] += 1
        return True

    # -- prefix hash-consing ---------------------------------------------------

    @staticmethod
    def prefix_keys(bucket: int, padded_tokens: np.ndarray,
                    block_size: int, cap: int) -> list:
        """Hash keys for the first ``cap`` full blocks of a padded prompt
        (the hash covers all tokens up to the block end; the bucket keys
        the positional frame the blocks were computed in)."""
        return [(bucket, hashlib.sha1(
                    padded_tokens[:k * block_size].tobytes()).digest())
                for k in range(1, cap + 1)]

    def lookup_prefix(self, keys: list):
        """Longest cached prefix among ``keys`` -> (n_blocks, pages)."""
        for k in range(len(keys), 0, -1):
            node = self.prefix_index.get(keys[k - 1])
            if node is not None:
                self.prefix_index.move_to_end(keys[k - 1])   # MRU
                self.stats["reused_blocks"] += k
                self.stats["reused_tokens"] += k * self.block_size
                return k, list(node.pages)
        return 0, []

    def register_prefix(self, keys: list, table: list) -> None:
        """Hash-cons the full prompt blocks of a freshly admitted request
        (each node holds a refcount on all its pages)."""
        for k, key in enumerate(keys, start=1):
            if key in self.prefix_index:
                self.prefix_index.move_to_end(key)
                continue
            pages = tuple(table[:k])
            self.incref(pages)
            self.prefix_index[key] = _PrefixNode(pages=pages, bucket=key[0])

    def ensure_private(self, table: list, blk: int) -> int:
        """Copy-on-write guard: the page a decode step writes must not be
        shared.  Returns the (possibly fresh) page id."""
        page = table[blk]
        if self.refcount[page] <= 1:
            return page
        [fresh] = self.alloc_pages(1)
        for pool in self.pools.values():
            sharding.local(pool)[fresh] = sharding.local(pool)[page]
        self.release([page])
        table[blk] = fresh
        self.stats["cow_copies"] += 1
        return fresh

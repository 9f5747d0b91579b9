"""Paged KV block pool (port of ``repro.serve.kvcache.PagedKVCache``).

The cache leaves that scale with the cache length (attention ``k``/``v``,
shaped ``(La, B, S, KV, hd)``, and an encoder-decoder's cross-KV ``xk``/
``xv``) are backed by pools shaped ``(num_blocks, La, block_size, KV,
hd)``: a page holds ``block_size`` rows of one request across all layers,
and requests own per-slot block tables of page ids; one table indexes every
pool.  The cross-KV leaves are static (``static``): written at prefill and
never by a decode step's write-back.  The rest of the cache is O(1) per
request and stays slot-resident (the "state" part): the ``len``/``len0``
counters, and the rwkv ``s``/``x_prev`` recurrent state.  A model with no
attention layer (rwkv6) has no paged leaf (``specs`` is empty): no pools,
no pages, no block writes.  The leaves come from the model's own cache
functions (``models.registry.model_module``).

Page 0 is permanently zero: block tables are padded with it, so the gather
materializes exact zeros for unallocated tail pages — what makes paged
decode bitwise-identical to the dense slot engine.  Pages carry refcounts
and a free list; full prompt blocks are hash-consed by
``(bucket, sha1(padded_tokens[:k*block_size]))`` and shared copy-on-write,
with LRU eviction of cached prefixes when the pool runs dry.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from ..models.registry import model_module

ZERO_PAGE = 0               # permanently zero; backs unallocated table slots


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

    def assemble(self, state: dict, tables: np.ndarray) -> dict:
        """The dense cache for a decode / continued-prefill step, gathered
        through ``tables`` (B, n_pages), padded with ZERO_PAGE."""
        t = torch.as_tensor(tables, dtype=torch.long, device=self.device)
        out = dict(state)
        for key, pool in self.pools.items():
            g = pool[t]                          # (B, np, L, bs, KV, hd)
            b, n_pages, n_l, bs = g.shape[:4]
            out[key] = g.permute(2, 0, 1, 3, 4, 5).reshape(
                n_l, b, n_pages * bs, *g.shape[4:])
        return out

    def write_blocks(self, cache: dict, slots, blks, pages,
                     skip_static: bool = False) -> None:
        """Scatter the (slot, blk) windows of a dense cache into pages;
        ``skip_static`` leaves the static leaves' pages as they are (a
        decode step's write-back)."""
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
            pool[p] = data.to(pool.dtype)
        self._track_peak()

    def _zero_pages(self, pages) -> None:
        p = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for pool in self.pools.values():
            pool[p] = 0

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
            pool[fresh] = pool[page]
        self.release([page])
        table[blk] = fresh
        self.stats["cow_copies"] += 1
        return fresh

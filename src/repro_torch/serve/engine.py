"""Batched serving engine: continuous batching over a paged KV cache (port
of ``repro.serve.engine``).

    rt = repro_torch.runtime.compile(cfg, state)
    engine = ServeEngine(rt, max_batch=4, max_len=256)

The ``Runtime`` owns the execution context and the prefill /
prefill_cont / decode entry points; the engine owns scheduling, the paged
block pool and per-request attribution of each call's ``AdOpsReport``.

* Admission prefills queued requests one at a time (batch 1), left-padded
  into power-of-two buckets.  When a prompt's leading blocks hit the prefix
  index, only the un-cached suffix is prefilled (``prefill_cont``).
* One ``step`` decodes a token for every active slot: the dense cache view
  is gathered from the pool through the block tables and the one written
  block per slot is scattered back — pure data movement, so the paged
  engine is bitwise-identical to the dense slot engine (``paged=False``),
  kept as the in-port reference.
* Idle slot rows are zeroed after every step, recurrent state (rwkv
  ``s``/``x_prev``) included: they ride through batched decode, and their
  content would leak into active rows through the dynamic max-abs scales
  of the fake_quant / pallas datapaths.
* A model with no paged leaf (rwkv6: its cache is O(1) recurrent state)
  allocates no page and writes no block; prefix reuse is off for it.
* Modality inputs come from ``extra_inputs(batch, seq)``, a dict of extra
  batch entries (an encoder-decoder's frames, ``embeds``).  An
  encoder-decoder's prefill gets pages for ``max(prompt bucket, frames)``
  rows, so its cross-KV rows have pages; a decode step writes back only
  the self-KV block it touched (the cross-KV is static).  Prefix reuse is
  off for it.
* A prompt is left-padded into its bucket, and a recurrent prefill steps
  its state over the padding tokens too, as the reference's does.
* Per-request metering: prefill ops go to their request exactly, a decode
  step's ops are split evenly over the slots that stepped.
* Sampling is greedy (``argmax``) at temperature 0, else categorical from
  the engine's ``torch.Generator`` (the reference's ``jax.random`` stream
  cannot be replayed, so only greedy tokens are comparable across the two).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.energy import adc_energy_pj
from .kvcache import ZERO_PAGE, PagedKVCache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S,) int32 prompt tokens
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 = greedy
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    ad_ops: float = 0.0
    prefill_ad_ops: float = 0.0
    reused_tokens: int = 0
    cache_len: int = 0                  # resident tokens (incl. padding)
    block_table: list = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> list:
        return list(self.prompt) + self.generated

    @property
    def ad_energy_pj(self) -> float:
        return adc_energy_pj(self.ad_ops)

    @property
    def decode_ad_ops(self) -> float:
        return self.ad_ops - self.prefill_ad_ops


def scatter_cache(big: dict, small: dict, slot: int) -> dict:
    """Insert a batch-1 cache into row ``slot`` of a batched one (every
    leaf's batch axis is the one the two shapes differ in).  Functional."""
    out = {}
    for key, b in big.items():
        s = small[key]
        ax = 0 if b.ndim == 1 else 1
        row = b.clone()
        row.narrow(ax, slot, 1).copy_(s.to(b.dtype))
        out[key] = row
    return out


def _attn_only(cfg) -> bool:
    """Prefix reuse needs every mixer to be attention: K/V blocks are a
    pure function of the prefix, while recurrent (mamba/rwkv) prefixes
    would need chunk-aligned state snapshots whose scan boundaries change
    the float associativity (not bitwise vs the monolithic prefill)."""
    try:
        kinds = {cfg.layer_kind(i)[0] for i in range(cfg.period)}
    except (AttributeError, TypeError):
        return False
    return (kinds == {"attn"} and cfg.encoder_layers == 0
            and cfg.frontend == "none")


class ServeEngine:
    """Continuous-batching serving loop around a compiled ``Runtime``."""

    def __init__(self, rt, *, max_batch: int = 8, max_len: int = 512,
                 extra_inputs: Optional[Callable[[int, int], dict]] = None,
                 paged: bool = True, block_size: int = 16,
                 prefix_reuse: bool = True,
                 num_blocks: Optional[int] = None, rng_seed: int = 0):
        self.rt = rt
        self.extra_inputs = extra_inputs or (lambda b, s: {})
        self.cfg = rt.cfg
        self.plan = rt.plan
        self.quant_state = rt.quant_state
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = rt.device
        self.paged = paged
        self.prefix_reuse = prefix_reuse and paged and _attn_only(self.cfg)
        if paged:
            self.kv = PagedKVCache(self.cfg, max_batch, max_len,
                                   block_size=min(block_size, max_len),
                                   num_blocks=num_blocks, device=self.device)
            self.block_size = self.kv.block_size
            self.state_cache = self.kv.make_state(max_batch)
            self.cache = None
        else:
            self.kv = None
            self.block_size = 0
            self.cache = rt.init_cache(max_batch, max_len)
        self.slots: list = [None] * max_batch
        self.queue: list = []
        self.finished: list = []
        self.total_ad_ops = 0.0
        self.prefill_ad_ops = 0.0
        self._uid = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0) -> Request:
        r = Request(self._uid, np.asarray(prompt, np.int32),
                    max_new_tokens=max_new_tokens, temperature=temperature,
                    submit_t=time.perf_counter())
        self._uid += 1
        self.queue.append(r)
        return r

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        greedy = torch.argmax(logits, -1)
        t = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
        if not (temps > 0).any():
            return greedy.to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float()
                              / torch.clamp_min(t, 1e-6)[:, None], -1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy).to(
            torch.int32).cpu().numpy()

    # -- scheduler -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _meter(self, r: Request, ops, prefill: bool = False) -> None:
        ops = float(ops)
        r.ad_ops += ops
        if prefill:
            r.prefill_ad_ops += ops
            self.prefill_ad_ops += ops
        self.total_ad_ops += ops

    def _finalize(self, r: Request) -> None:
        r.done = True
        r.finish_t = time.perf_counter()
        if r.first_token_t == 0.0:
            r.first_token_t = r.finish_t
        self.finished.append(r)
        if self.paged and r.block_table:
            self.kv.release(r.block_table)
            r.block_table = []

    def _zero_slot(self, slot: int) -> None:
        """Zero an idle slot's cache row, recurrent state included (see
        module docstring)."""
        if self.paged:
            self.state_cache = scatter_cache(self.state_cache,
                                             self.kv.make_state(1), slot)
        else:
            self.cache = scatter_cache(self.cache, self.rt.init_cache(
                1, self.max_len), slot)

    def _prefill(self, r: Request):
        """Prefill ``r`` (reusing cached prefix blocks when possible), write
        its blocks, sample its first token and meter its ops.  Returns the
        batch-1 cache."""
        plen = int(min(len(r.prompt), self.max_len - r.max_new_tokens))
        padded = self._bucket(plen)
        toks = np.zeros((1, padded), np.int32)
        toks[0, -plen:] = r.prompt[-plen:]   # left-pad into the bucket
        extra = self.extra_inputs(1, padded)
        # an encoder-decoder's frames are its cross-KV rows: pages for them
        rows = max(padded, int(extra["embeds"].shape[1])) \
            if "embeds" in extra else padded
        bs = self.block_size

        reuse_n, keys = 0, []
        if self.prefix_reuse and padded >= bs:
            # only FULL blocks are shareable; always leave >=1 suffix token
            cap = min((padded - 1) // bs, self.kv.pages_per_slot)
            keys = self.kv.prefix_keys(padded, toks[0], bs, cap)
            reuse_n, shared = self.kv.lookup_prefix(keys)

        if reuse_n:
            self.kv.incref(shared)
            r.block_table = list(shared)
            n_reused = reuse_n * bs
            table1 = np.full((1, padded // bs), ZERO_PAGE, np.int32)
            table1[0, :reuse_n] = shared
            dense1 = self.kv.assemble(self.kv.make_state(1, n_reused),
                                      table1)
            positions = np.arange(n_reused, padded, dtype=np.int32)[None]
            (last_logits, small), rep = self.rt.prefill_cont(
                toks[:, n_reused:], positions, dense1)
            r.reused_tokens = n_reused
        else:
            (last_logits, small), rep = self.rt.prefill(
                toks, extra, max_len=self.max_len)
        self._meter(r, rep.ad_ops, prefill=True)

        if self.paged and self.kv.specs:
            n_blk = min(-(-rows // bs), self.kv.pages_per_slot)
            new_blks = np.arange(reuse_n, n_blk, dtype=np.int32)
            if len(new_blks):
                new_pages = self.kv.alloc_pages(len(new_blks))
                r.block_table.extend(new_pages)
                self.kv.write_blocks(small, np.zeros(len(new_blks), np.int32),
                                     new_blks, new_pages)
            if keys:
                self.kv.register_prefix(keys, r.block_table)
        r.cache_len = padded

        nxt = self._sample(last_logits, np.array([r.temperature]))
        r.first_token_t = time.perf_counter()
        if r.max_new_tokens > 0:
            r.generated.append(int(nxt[0]))
        return small

    def _install(self, r: Request, small, slot: int) -> None:
        if self.paged:
            self.state_cache = scatter_cache(
                self.state_cache, self.kv.state_only(small), slot)
        else:
            self.cache = scatter_cache(self.cache, small, slot)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is not None:
                continue
            while self.queue:
                r = self.queue.pop(0)
                small = self._prefill(r)
                if len(r.generated) >= r.max_new_tokens:
                    self._finalize(r)        # prefill-only request
                    continue
                self._install(r, small, slot)
                self.slots[slot] = r
                break

    def _write_blk(self, r: Request) -> int:
        """Block this decode step writes (the cache scatter clamps at the
        buffer end, as the dense engine's does)."""
        return min(r.cache_len, self.max_len - 1) // self.block_size

    def _decode_cache(self):
        if not self.paged:
            return self.cache
        tables = np.full((self.max_batch, self.kv.pages_per_slot),
                         ZERO_PAGE, np.int32)
        for i, r in enumerate(self.slots):
            if r is None or not self.kv.specs:
                continue
            blk = self._write_blk(r)
            while len(r.block_table) <= blk:
                r.block_table.extend(self.kv.alloc_pages(1))
            self.kv.ensure_private(r.block_table, blk)
            tables[i, :len(r.block_table)] = r.block_table
        return self.kv.assemble(self.state_cache, tables)

    def _writeback(self, new_cache, active: list) -> None:
        if not self.paged:
            self.cache = new_cache
            return
        self.state_cache = self.kv.state_only(new_cache)
        if not self.kv.specs:
            return
        blks = [self._write_blk(self.slots[i]) for i in active]
        pages = [self.slots[i].block_table[b] for i, b in zip(active, blks)]
        self.kv.write_blocks(new_cache, active, blks, pages,
                             skip_static=True)

    def step(self) -> int:
        """Admit + one decode step for all active slots.  Returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        toks = np.zeros((self.max_batch, 1), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        for i in active:
            toks[i, 0] = self.slots[i].generated[-1]
            temps[i] = self.slots[i].temperature
        (logits, new_cache), rep = self.rt.decode(
            toks, self._decode_cache(), self.extra_inputs(self.max_batch, 1))
        self._writeback(new_cache, active)
        ops = float(rep.ad_ops)
        share = ops / len(active)
        self.total_ad_ops += ops
        nxt = self._sample(logits, temps)
        for i in active:
            r = self.slots[i]
            r.ad_ops += share
            r.generated.append(int(nxt[i]))
            r.cache_len += 1
            if len(r.generated) >= r.max_new_tokens:
                self._finalize(r)
                self.slots[i] = None
        for i in range(self.max_batch):
            if self.slots[i] is None:
                self._zero_slot(i)
        return len(active)

    def run(self, max_steps: int = 10_000) -> list:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- metrics ---------------------------------------------------------------

    def stats(self) -> dict:
        if not self.finished:
            return {}
        ttft = [r.first_token_t - r.submit_t for r in self.finished]
        lat = [r.finish_t - r.submit_t for r in self.finished]
        toks = sum(len(r.generated) for r in self.finished)
        span = max(r.finish_t for r in self.finished) - \
            min(r.submit_t for r in self.finished)
        per_req = [r.ad_ops for r in self.finished]
        out = {"requests": len(self.finished),
               "mean_ttft_s": float(np.mean(ttft)),
               "mean_latency_s": float(np.mean(lat)),
               "decode_tokens": toks,
               "tokens_per_s": toks / max(span, 1e-9),
               "total_ad_ops": self.total_ad_ops,
               "prefill_ad_ops": self.prefill_ad_ops,
               "decode_ad_ops": self.total_ad_ops - self.prefill_ad_ops,
               "mean_ad_ops_per_request": float(np.mean(per_req)),
               "total_ad_energy_pj": adc_energy_pj(self.total_ad_ops),
               "mean_ad_energy_pj_per_request":
                   adc_energy_pj(np.mean(per_req)),
               "reused_prompt_tokens": sum(r.reused_tokens
                                           for r in self.finished)}
        if self.paged:
            out["paged"] = {
                "block_size": self.block_size,
                "num_blocks": self.kv.num_blocks,
                "pages_in_use": int((self.kv.refcount > 0).sum()) - 1,
                "prefix_nodes": len(self.kv.prefix_index),
                **self.kv.stats}
        return out

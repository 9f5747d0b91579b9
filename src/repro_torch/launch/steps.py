"""Cell builders: (arch x shape x mesh) -> a step, its arguments and their
placements (port of ``repro.launch.steps``).

One *cell* is an assigned (architecture, input-shape) pair on a mesh.
This module builds, without allocating anything:

* the step function (a train step for ``train`` cells, a serving step for
  prefill/decode cells),
* ``meta``-device stand-ins for every argument,
* each argument's spec on the mesh.

Cells come from an *abstract* :class:`repro_torch.runtime.Runtime` (its
parameters are ``meta`` DTensors placed on the mesh): the Runtime
resolves the execution context (mesh, backend, QuantState, the plan) in
its one place, and the steps are ``Runtime.serve_cell_step`` /
``Runtime.train_cell_step``.  ``launch/dryrun.py`` runs each step once on
the meta device; ``launch/train.py`` / ``launch/serve.py`` run concrete
Runtimes on the host mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import runtime as rt_mod
from ..configs.base import (LONG_CONTEXT_ARCHS, ModelConfig, SHAPES,
                            ShapeConfig, TrainConfig)
from ..dist import sharding
from ..dist.sharding import P
from ..models.registry import build_model, get_config, model_module
from ..serve.kvcache import step_pspecs

# patch-prefix length for the VLM frontend stub (internvl2: 1024-token tiles)
VLM_PATCHES = 1024

# per-arch training overrides (the optimizer-state tricks the large archs
# need to fit)
TRAIN_OVERRIDES: dict = {
    # 480B params: f32 master + bf16-m + factored-v + ZeRO-1 ≈ 11 GB/chip
    "arctic-480b": dict(optimizer_dtype="bfloat16",
                        factored_second_moment=True),
    "internvl2-76b": dict(optimizer_dtype="bfloat16"),
    "deepseek-67b": dict(optimizer_dtype="bfloat16"),
}
# archs whose MoE expert-FFN dim is also sharded over 'data' (weight-gather
# FSDP style) so expert weights fit
MOE_FFN_SHARD_DATA = ("arctic-480b",)


def valid_cells(arch: str) -> list:
    """Shape names this arch runs (long_500k only for sub-quadratic
    mixers; every other cell runs everywhere)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return names


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "N/A: 512k dense-attention decode (quadratic KV read) " \
               "excluded by task spec; runs only for SSM/hybrid archs"
    return None


# ---------------------------------------------------------------------------
# input stand-ins (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _tok(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def _emb(b: int, s: int, d: int) -> torch.Tensor:
    return torch.empty((b, s, d), dtype=torch.float32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of one cell as meta tensors.  Frontends are stubs:
    'embeds' carries precomputed patch/frame embeddings."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.encoder_layers:                     # whisper: enc frames + dec
            return {"embeds": _emb(b, s, cfg.d_model),
                    "tokens": _tok(b, s), "labels": _tok(b, s)}
        if cfg.frontend == "patch":                # vlm: patch prefix + text
            return {"embeds": _emb(b, VLM_PATCHES, cfg.d_model),
                    "tokens": _tok(b, s - VLM_PATCHES), "labels": _tok(b, s)}
        return {"tokens": _tok(b, s), "labels": _tok(b, s)}
    if shape.kind == "prefill":
        if cfg.encoder_layers:
            return {"embeds": _emb(b, s, cfg.d_model), "tokens": _tok(b, s)}
        if cfg.frontend == "patch":
            return {"embeds": _emb(b, VLM_PATCHES, cfg.d_model),
                    "tokens": _tok(b, s - VLM_PATCHES)}
        return {"tokens": _tok(b, s)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _tok(b, 1)}


def batch_shardings(mesh, specs: dict) -> dict:
    """{input: spec}: the batch dim over the data axes when it divides
    them; the sequence dim unsharded."""
    names = sharding.axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    n_dp = 1
    for a in dp:
        n_dp *= sharding.axis_size(mesh, a)

    def one(leaf):
        b_ax = dp if leaf.shape[0] % max(n_dp, 1) == 0 and \
            leaf.shape[0] >= n_dp else None
        return P(*((b_ax,) + (None,) * (leaf.ndim - 1)))
    return {k: one(v) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# cell = step fn + args + specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    step_fn: object            # callable
    args: tuple                # meta tensors and trees of them
    in_specs: tuple            # each argument's specs (a tree like it)
    runtime: object            # the abstract Runtime the step runs

    def run(self):
        """Run the step once (on the meta device: no data)."""
        return self.step_fn(*self.args)


def make_train_config(arch: str, **kw) -> TrainConfig:
    over = dict(TRAIN_OVERRIDES.get(arch, {}))
    over.update(kw)
    return TrainConfig(**over)


def _meta_state(cfg: ModelConfig) -> dict:
    return {n: p for n, p in build_model(cfg).named_parameters()}


def build_train_cell(arch: str, mesh, shape_name: str = "train_4k",
                     cfg: Optional[ModelConfig] = None,
                     tc: Optional[TrainConfig] = None,
                     quant_state=None) -> Cell:
    cfg = cfg or get_config(arch)
    tc = tc or make_train_config(arch)
    shape = SHAPES[shape_name]
    moe_fsdp = arch in MOE_FFN_SHARD_DATA
    rt = rt_mod.compile(cfg, _meta_state(cfg), device="meta", mesh=mesh,
                        quant_state=quant_state, plan=None, tc=tc,
                        moe_ffn_shard_data=moe_fsdp)
    step, opt_init = rt.train_cell_step(tc)
    p_specs, o_specs = rt.train_specs()
    opt_s = opt_init()
    batch_s = input_specs(cfg, shape)
    b_specs = batch_shardings(mesh, batch_s)
    step_s = torch.zeros((), dtype=torch.int32, device="meta")
    return Cell(arch=arch, shape=shape, cfg=cfg, step_fn=step,
                args=(rt.params, opt_s, batch_s, step_s),
                in_specs=(p_specs, o_specs, b_specs, P()), runtime=rt)


def build_serve_cell(arch: str, mesh, shape_name: str,
                     cfg: Optional[ModelConfig] = None, quant_state=None,
                     prepare_plan: bool = False) -> Cell:
    """prefill: the prompt forward writing a fresh cache, next-token
    argmax.  decode: one token for every sequence against a seq_len-deep
    cache, of which each rank holds and attends its share.
    ``prepare_plan=True`` programs the weight-stationary plan
    (replicated: a plan holds whole derived weight images) and passes it
    to the step, as the ServeEngine's Runtime serves."""
    cfg = cfg or get_config(arch)
    # serving runs the paper's datapath: weights bf16
    cfg = cfg.replace(param_dtype="bfloat16", remat="none")
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        # per-token weight gathers would multiply decode HBM traffic by the
        # model-axis size; decode always runs Megatron-TP
        cfg = cfg.replace(parallelism="tp")
    b = shape.global_batch
    moe_fsdp = arch in MOE_FFN_SHARD_DATA
    rt = rt_mod.compile(cfg, _meta_state(cfg), device="meta", mesh=mesh,
                        quant_state=quant_state,
                        plan=True if prepare_plan else None,
                        moe_ffn_shard_data=moe_fsdp)
    with sharding.use_mesh(mesh):
        p_specs = sharding.param_pspecs(rt.params, moe_fsdp)
    batch_s = input_specs(cfg, shape)
    b_specs = batch_shardings(mesh, batch_s)
    plan_s = rt.plan
    pl_specs = None if plan_s is None else "replicated"
    step = rt.serve_cell_step(shape.kind, b, shape.seq_len)
    if shape.kind == "prefill":
        return Cell(arch=arch, shape=shape, cfg=cfg, step_fn=step,
                    args=(rt.params, plan_s, batch_s),
                    in_specs=(p_specs, pl_specs, b_specs), runtime=rt)
    # the cache as the decode step holds it: each rank's rows and share
    # of the K/V heads, DTensors on meta (``kvcache.step_pspecs``)
    whole = model_module(cfg).init_cache(cfg, b, shape.seq_len,
                                         device="meta")
    c_specs = step_pspecs(mesh, cfg, whole, b)
    cache_s = {k: sharding.zeros_placed(v.shape, v.dtype, "meta", mesh,
                                        c_specs[k])
               for k, v in whole.items()}
    return Cell(arch=arch, shape=shape, cfg=cfg, step_fn=step,
                args=(rt.params, plan_s, cache_s, batch_s),
                in_specs=(p_specs, pl_specs, c_specs, b_specs), runtime=rt)


def build_cell(arch: str, mesh, shape_name: str,
               cfg: Optional[ModelConfig] = None, **kw) -> Cell:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(arch, mesh, shape_name, cfg=cfg, **kw)
    return build_serve_cell(arch, mesh, shape_name, cfg=cfg, **kw)


# ---------------------------------------------------------------------------
# depth-reduced variants (parity with the reference; see dryrun.py)
# ---------------------------------------------------------------------------

def depth_variant(cfg: ModelConfig, n_periods: int,
                  seq_len: int = 1 << 30) -> ModelConfig:
    """Same width, ``n_periods`` periods, layers unrolled and attention in
    one chunk: the reference's variants for its FLOP differencing (XLA
    counts a scan body once).  The port's counter runs every layer
    eagerly and needs no differencing; the dry run takes a variant only to
    keep a run short (``--depth-periods``)."""
    kw = dict(n_layers=cfg.period * n_periods, scan_layers=False,
              attn_chunk_q=seq_len, attn_chunk_k=seq_len)
    if cfg.encoder_layers:
        kw["encoder_layers"] = n_periods
    return cfg.replace(**kw)

"""One explicit execution context: the ``Runtime`` object (port of
``repro.runtime.runtime``).

    rt = repro_torch.runtime.compile(cfg, state)       # device: cuda
    (logits, cache, _), report = rt.apply(batch)       # report.ad_ops

A ``Runtime`` owns the model on its device, the mesh (when it has one),
the backend name, the per-layer ``QuantState``, the ``CrossbarModel`` of
the simulated device, the weight-stationary ``PimPlan`` and the entry
points ``prefill`` / ``prefill_cont`` / ``decode`` / ``apply`` / ``mvm``,
each returning ``(out, AdOpsReport)``.  PyTorch runs eagerly, so there is
nothing to jit; every serving entry point runs under ``torch.no_grad``.

On a mesh (``compile(..., mesh=...)`` or an active ``use_mesh``) every
parameter is a DTensor placed by ``param_pspecs`` and each layer gathers
its own for its forward (``dist.sharding.gather_hooks``).  Every rank runs
the same program: an entry point takes the whole batch, the data axes
split its rows when they divide it, and under ``fsdp_cp`` the model axis
splits the sequence when it divides it (``dist.group``); the dynamic
scales, the auto-range maximum and the A/D count are reduced over the
split axes, and the logits and the cache come back whole, so every rank
returns what one device would.  A decode step splits the attention heads
over the model axis, the reference's cache layout (``dist.group.
head_share``): each rank keeps and attends its share of the K/V cache;
``decode(kv_share=True)`` takes and returns that share as the serving
engine's pools hold it; plain ``decode`` takes a whole cache and attends
whole heads on every rank.  A Runtime whose
parameters are on the ``meta`` device is *abstract*: its steps run on no
data (the dry run's cells).

Training (``opt_init``, ``train_step``) runs on the differentiable
backends (``exact``, and ``fake_quant`` through its straight-through
estimator) with no plan, as the reference's train CLI compiles it; it
updates the model's parameters (``Runtime.params``) and the optimizer
state in place, as the reference's ``donate=True``.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core import quant_state as qs_mod
from ..core.energy import adc_energy_pj
from ..core.quant_state import QuantState, save_quant_state
from ..device import resolve_device
from ..dist import group, sharding
from ..models.layers import PimContext, pim_linear
from ..models.registry import build_model, model_module
from ..pim import backend as backend_mod
from ..pim import noise as noise_mod
from ..pim.backend import active_backend, get_backend
from ..pim.noise import (CrossbarModel, active_crossbar_model,
                         crossbar_token, is_noise_aware)
from ..pim.plan import (PimPlan, check_plan, has_prepared, prepare_params,
                        quant_state_token)

_UNSET = object()
# the backends with a gradient path (the reference's train CLI's choices:
# pallas and bit_exact have no VJP, noisy draws its faults once per plan)
TRAIN_BACKENDS = ("exact", "fake_quant")


class AdOpsReport(NamedTuple):
    """The A/D-conversion accounting of one call: ``ad_ops`` is the summed
    SAR comparator-cycle count (Eq. 6), a 0-dim int64 device tensor."""

    ad_ops: torch.Tensor

    def total(self) -> float:
        return float(self.ad_ops)

    @property
    def ad_energy_pj(self) -> float:
        return adc_energy_pj(self.total())


class Runtime:
    """A compiled execution context (see module docstring).  Construct it
    through :func:`compile`."""

    def __init__(self, cfg: ModelConfig, model, *, backend: str,
                 quant_state: Optional[QuantState], plan: Optional[PimPlan],
                 device: torch.device, plan_enabled: bool = True,
                 crossbar_model: Optional[CrossbarModel] = None,
                 tc: Optional[TrainConfig] = None, mesh=None,
                 moe_ffn_shard_data: bool = False):
        self.cfg = cfg
        self.model = model
        self.tc = tc
        self.mesh = mesh
        self.moe_ffn_shard_data = moe_ffn_shard_data
        self.params = dict(model.named_parameters())
        self._train = None              # (train_step, opt_init), built once
        self._step_ctx = None           # the PimContext of the running step
        self.backend = backend
        self.quant_state = quant_state
        self.plan = plan
        self.crossbar_model = crossbar_model
        self.device = device
        self._plan_enabled = plan_enabled
        self.forward_calls = 0          # forwards run by serving entry points

    def __repr__(self) -> str:
        return (f"Runtime({self.cfg.name}, backend={self.backend!r}, "
                f"plan={'yes' if self.plan is not None else 'no'}, "
                f"quant_state="
                f"{'yes' if self.quant_state is not None else 'no'}, "
                f"crossbar_model="
                f"{'yes' if self.crossbar_model is not None else 'no'}, "
                f"device={self.device}, mesh="
                f"{None if self.mesh is None else sharding.mesh_str(self.mesh)}"
                f")")

    @contextlib.contextmanager
    def _ambient(self, split: tuple = ()):
        """The one place the Runtime installs ambient state: its mesh (and
        the mesh axes over which the forward's rows are split), then its
        backend, QuantState and CrossbarModel, force-installed (``None``
        included), so a ``use_backend``/``use_quant_state`` a caller nests
        around an entry point never reaches it."""
        with contextlib.ExitStack() as stack:
            if self.mesh is not None:
                stack.enter_context(sharding.use_mesh(self.mesh))
            stack.enter_context(group.split_rows(split))
            prev = (backend_mod._ACTIVE["backend"], qs_mod._ACTIVE["qs"],
                    noise_mod._ACTIVE["cm"])
            backend_mod._ACTIVE["backend"] = self.backend
            qs_mod._ACTIVE["qs"] = self.quant_state
            noise_mod._ACTIVE["cm"] = self.crossbar_model
            try:
                yield self
            finally:
                (backend_mod._ACTIVE["backend"], qs_mod._ACTIVE["qs"],
                 noise_mod._ACTIVE["cm"]) = prev

    def rows(self, batch: int) -> Optional[slice]:
        """This rank's rows of a ``batch``-row call, or None for all."""
        return group.batch_share(self.mesh, batch)

    def _split(self, batch: int, length: int):
        """``(share, axes)``: this rank's rows of a ``batch``-row call (or
        None) and the mesh axes that split the forward's rows: the data
        axes with a share, ``'model'`` when the layout splits a
        ``length``-row sequence (:func:`dist.group.seq_share`)."""
        share = self.rows(batch)
        axes = group.dp_axes(self.mesh) if share is not None else ()
        if group.seq_share(self.mesh, self.cfg, length) is not None:
            axes += ("model",)
        return share, axes

    def _length(self, tokens, embeds=None) -> int:
        """The decoder sequence of a call: a patch frontend's F rows
        prefix the S tokens."""
        f = embeds.shape[1] if embeds is not None and \
            self.cfg.frontend == "patch" else 0
        return f + tokens.shape[1]

    def _ctx(self) -> PimContext:
        # the Runtime's device model wins over an ambient one, None included
        return PimContext(self.cfg, self.backend, self.quant_state,
                          self.plan, self.device,
                          self.crossbar_model or _IDEAL)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(x, dtype=dtype, device=self.device)   # a copy

    def _forward(self, tokens, *, cache=None, mode: str, positions=None,
                 extra: Optional[dict] = None, whole_cache: bool = True,
                 cache_is_share: bool = False, kv_share: bool = False):
        """The model forward of an entry point.  On a mesh whose data axes
        split the batch, this rank runs its rows (``cache_is_share``: the
        cache holds only those already) and the logits, and unless
        ``whole_cache`` is False the cache, come back whole.  A sequence
        split on the model axis runs this rank's block of the rows; the
        model returns the cache whole and the serving logits on every
        rank, and the train-mode logits are gathered here.  With
        ``kv_share`` (a decode step) the model axis splits the heads: the
        paged (K/V) leaves come in as this rank's share and go back as
        this rank holds them (its heads, its rows), never gathered;
        without, every rank attends whole heads."""
        ctx = self._ctx()
        kw = {}
        if positions is not None:
            kw["positions"] = self._tensor(positions)
        if extra:
            if mode == "decode":
                raise ValueError(f"decode takes no modality inputs; got "
                                 f"{sorted(extra)}")
            if not (self.cfg.encoder_layers or self.cfg.frontend == "patch") \
                    or set(extra) != {"embeds"}:
                raise NotImplementedError(
                    f"{self.cfg.name}: modality inputs {sorted(extra)} are "
                    f"not ported (an encoder-decoder or a patch frontend "
                    f"takes 'embeds')")
            kw.update(self._modality(extra))
        tokens = self._tensor(tokens)
        share, axes = self._split(len(tokens),
                                  self._length(tokens, kw.get("embeds")))
        heads = group.head_share(self.mesh, self.cfg) \
            if mode == "decode" and kv_share else None
        held = model_module(self.cfg).paged_keys(self.cfg) if kv_share \
            else ()
        if share is not None:
            tokens = tokens[share]
            kw = {k: v[share] for k, v in kw.items()}
            if cache is not None and not cache_is_share:
                cache = {k: v[share] if v.ndim == 1 else v[:, share]
                         for k, v in cache.items()}
        with torch.no_grad(), self._ambient(axes), group.split_heads(heads):
            logits, new_cache, aux = self.model(tokens, ctx, cache=cache,
                                                mode=mode, **kw)
            ops = group.global_sum(ctx.ops)
            if "model" in axes and mode == "train":
                logits = group.gather_rows(logits, 1, self.mesh, ("model",))
            if share is not None:
                logits = group.gather_rows(logits, 0, self.mesh)
                if new_cache is not None and whole_cache:
                    new_cache = {k: v if k in held else group.gather_rows(
                        v, 0 if v.ndim == 1 else 1, self.mesh)
                        for k, v in new_cache.items()}
        self.forward_calls += 1
        return logits, new_cache, aux, AdOpsReport(ops)

    def _modality(self, extra: dict) -> dict:
        return {"embeds": self._tensor(extra["embeds"], torch.float32)} \
            if "embeds" in extra else {}

    def init_cache(self, batch: int, max_len: int) -> dict:
        """The model's own zeroed cache (an encoder-decoder's cross-KV is
        ``max_len`` rows deep, the reference's rule)."""
        return model_module(self.cfg).init_cache(self.cfg, batch, max_len,
                                                 device=self.device)

    # -- entry points (each returns (out, AdOpsReport)) ----------------------

    def apply(self, batch: dict, cache=None, mode: str = "train"):
        """The model forward: ``((logits, cache, aux), AdOpsReport)``;
        ``batch`` holds ``tokens`` and optionally ``positions`` (and,
        outside decode, an encoder-decoder's frames or a patch frontend's
        embeddings as ``embeds``)."""
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "positions")}
        logits, new_cache, aux, rep = self._forward(
            batch["tokens"], cache=cache, mode=mode,
            positions=batch.get("positions"), extra=extra)
        return (logits, new_cache, aux), rep

    def prefill(self, tokens, extra: Optional[dict] = None, *,
                max_len: int):
        """Prompt forward writing a fresh ``max_len``-deep cache:
        ``((last_logits, cache), AdOpsReport)``.  ``tokens``: (B, plen);
        an encoder-decoder takes its frames, a patch frontend its patch
        embeddings (cache rows before the prompt's) as ``extra={"embeds":
        (B, T, D)}``."""
        logits, cache, rep = self._prefill(tokens, extra, max_len, True)
        return (logits[:, -1], cache), rep

    def _prefill(self, tokens, extra, max_len: int, whole_cache: bool):
        share = self.rows(len(tokens))
        rows = len(tokens) if share is None else share.stop - share.start
        cache = self.init_cache(rows, max_len)
        logits, cache, _, rep = self._forward(
            tokens, cache=cache, mode="prefill", extra=extra,
            whole_cache=whole_cache, cache_is_share=True)
        return logits, cache, rep

    def prefill_cont(self, tokens, positions, cache):
        """Continued prefill against a warm cache (prefix-reuse path)."""
        logits, cache, _, rep = self._forward(tokens, cache=cache,
                                              mode="prefill_cont",
                                              positions=positions)
        return (logits[:, -1], cache), rep

    def decode(self, tokens, cache, extra: Optional[dict] = None, *,
               kv_share: bool = False):
        """One token for every sequence in ``cache``; ``extra`` must be
        empty (an encoder-decoder reads its cross-KV from the cache, a
        patch frontend's rows are in it).  ``cache`` is whole and comes
        back whole; with ``kv_share`` its paged (K/V) leaves are this
        rank's share of the heads (``dist.group.head_share``, every row)
        and come back as this rank holds them: its heads, its rows
        (:meth:`rows`).  Each rank then attends only its share and no
        collective reads the cache (the serving engine's pools)."""
        logits, cache, _, rep = self._forward(tokens, cache=cache,
                                              mode="decode", extra=extra,
                                              kv_share=kv_share)
        return (logits[:, -1], cache), rep

    def mvm(self, x: torch.Tensor, layer: str):
        """Run ONE layer's MVM on the Runtime's datapath: ``(y,
        AdOpsReport)``.  ``layer`` is a QuantState-style name: with an
        absolute depth (``layer_3/attn/wq``), or an encoder-decoder's
        (``enc/attn/wq``, ``dec/xattn/wk``, ``frontend/frame_proj``),
        whose stacked families resolve to depth 0 as in the reference, or
        a frontend's (``frontend/patch_proj``)."""
        parts = layer.split("/")
        if parts[0].startswith("layer_"):
            parts = ["layers", parts[0].split("_", 1)[1], *parts[1:]]
        elif parts[0] in ("enc", "dec") and self.cfg.encoder_layers > 0:
            parts = [parts[0], "0", *parts[1:]]
        elif parts[0] != "frontend" or self.cfg.frontend == "none":
            raise KeyError(f"no layer {layer!r} in the model")
        path = ".".join(parts)
        try:
            lin = self.model.get_submodule(path)
        except AttributeError:
            raise KeyError(f"no layer {layer!r} in the model") from None
        ctx = self._ctx()
        with torch.no_grad(), self._ambient(), sharding.gathered(lin):
            y = pim_linear(lin, x.to(self.device), ctx)
        return y, AdOpsReport(ctx.ops)

    # -- training ---------------------------------------------------------------

    def _train_pair(self):
        """(train_step, opt_init) of the Runtime's ``TrainConfig``, built
        once; the parameters get gradients from here on."""
        if self._train is None:
            if self.backend not in TRAIN_BACKENDS:
                raise ValueError(
                    f"backend {self.backend!r} has no gradient path; train "
                    f"on one of {TRAIN_BACKENDS} (fake_quant is QAT through "
                    f"the straight-through estimator)")
            if self.plan is not None:
                raise ValueError("training updates the weights a plan "
                                 "freezes; compile with plan=None")
            from ..train.loop import make_train_step

            def apply_fn(batch):
                logits, _, aux = self.model(
                    batch["tokens"], self._step_ctx, mode="train",
                    **self._modality(batch))
                return logits, aux
            for p in self.params.values():
                p.requires_grad_(True)
            self._train = make_train_step(apply_fn, self.cfg,
                                          self.tc or TrainConfig())
        return self._train

    def opt_init(self, params: Optional[dict] = None) -> dict:
        """Optimizer state for the Runtime's ``TrainConfig``, in the
        reference's layout (``train.optimizer``); on a mesh each moment
        is a DTensor placed by :meth:`train_specs` (ZeRO-1)."""
        params = self.params if params is None else params
        if self.mesh is None:
            return self._train_pair()[1](params)
        return self._train_pair()[1](params, mesh=self.mesh,
                                     specs=self.train_specs()[1])

    def train_specs(self, moe_ffn_shard_data: Optional[bool] = None):
        """(parameter specs, optimizer-state specs) on the Runtime's mesh
        (``train.loop.shardings_for``)."""
        from ..train.loop import shardings_for
        from ..train.optimizer import make_optimizer
        tc = self.tc or TrainConfig()
        moe = self.moe_ffn_shard_data if moe_ffn_shard_data is None \
            else moe_ffn_shard_data
        shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                  for n, p in self.params.items()}
        opt_s = make_optimizer(tc, self.cfg)[0](shapes)
        return shardings_for(self.mesh, shapes, opt_s, tc,
                             moe_ffn_shard_data=moe, cfg=self.cfg)

    def train_setup(self, *, moe_ffn_shard_data: Optional[bool] = None):
        """Sharded training assembly for the launchers: ``(step, opt_init,
        p_specs, o_specs)``, ``step(params, opt_state, batch, i) ->
        (params, opt_state, metrics)`` with ``metrics['ad_ops']`` and the
        optimizer state ZeRO-1 placed by ``opt_init()``.  Needs a
        mesh-owning Runtime."""
        if self.mesh is None:
            raise ValueError("train_setup needs a mesh-owning Runtime; "
                             "compile(..., mesh=...) or enter use_mesh first")
        p_specs, o_specs = self.train_specs(moe_ffn_shard_data)
        return self._step, self.opt_init, p_specs, o_specs

    def _step(self, params, opt_state, batch, i):
        """The launchers' contract: ``(params, opt_state, metrics)``."""
        return self.train_step(params, opt_state, batch, i)[0]

    def train_step(self, params: dict, opt_state: dict, batch: dict, step):
        """One optimizer step: ``((params, opt_state, metrics),
        AdOpsReport)``, ``metrics`` holding ``loss``, ``gnorm``, ``lr`` and
        ``ad_ops`` (each forward conversion counted once, rematerialised
        layers included).  ``params`` other than ``Runtime.params`` are
        copied into the model first; the model's parameters and
        ``opt_state`` are updated in place and returned.  ``batch`` holds
        ``tokens`` and ``labels`` (B, S) and, for an encoder-decoder, its frames
        as ``embeds``; a patch frontend's F ``embeds`` rows prefix the
        tokens, so its labels must have F + S rows (the reference's train
        cell), else ``ValueError`` before any forward."""
        if self.cfg.frontend == "patch" and "embeds" in batch and \
                batch["embeds"].shape[1] + batch["tokens"].shape[1] != \
                batch["labels"].shape[1]:
            raise ValueError(
                f"{self.cfg.name}: the patch rows prefix the sequence, so "
                f"the forward returns logits over F + S rows against S "
                f"labels; the reference's loss (src/repro/train/loop.py:"
                f"34-35) fails on the same batch")
        step_fn, _ = self._train_pair()
        if params is not self.params:
            with torch.no_grad():
                for name, live in self.params.items():
                    if params[name] is not live:
                        live.copy_(params[name])
        batch = {k: self._tensor(v, torch.float32 if k == "embeds"
                                 else torch.int32) for k, v in batch.items()}
        length = self._length(batch["tokens"], batch.get("embeds"))
        share, axes = self._split(len(batch["tokens"]), length)
        shards = 1
        if share is not None:
            batch = {k: v[share] for k, v in batch.items()}
            shards = group.dp_size(self.mesh)
        if "model" in axes:     # the model takes its block after the embed
            batch["labels"] = batch["labels"][
                :, group.seq_share(self.mesh, self.cfg, length)]
        ctx = self._step_ctx = self._ctx()
        try:
            with self._ambient(axes):
                _, opt_state, metrics = step_fn(self.params, opt_state,
                                                batch, step, shards=shards)
                ops = group.global_sum(ctx.ops)
        finally:
            self._step_ctx = None
        metrics["ad_ops"] = ops
        return (self.params, opt_state, metrics), AdOpsReport(ops)

    # -- cell derivation (launch.steps / the dry run) ---------------------------

    def serve_cell_step(self, kind: str, batch_size: int, seq_len: int):
        """A launch cell's serving step: ``step(params, plan, batch)`` for
        ``prefill`` (a fresh ``seq_len``-deep cache) or ``step(params,
        plan, cache, batch)`` for ``decode``, returning (argmax tokens,
        the new cache as this rank holds it).  The parameters and plan run
        are the Runtime's own; the arguments carry their placements: a
        decode cell's cache is DTensors placed by ``kvcache.step_pspecs``
        (this rank's rows and share of the heads), which the step reads
        and returns as local tensors."""
        def extra_of(batch):
            return {k: v for k, v in batch.items() if k == "embeds"}

        if kind == "prefill":
            def step(params, plan, batch):
                logits, cache, _ = self._prefill(
                    batch["tokens"], extra_of(batch), seq_len, False)
                return torch.argmax(logits[:, -1], -1), cache
            return step

        def step(params, plan, cache, batch):
            cache = {k: sharding.local(v) for k, v in cache.items()}
            logits, cache, _, _ = self._forward(
                batch["tokens"], cache=cache, mode="decode",
                whole_cache=False, cache_is_share=True, kv_share=True)
            return torch.argmax(logits[:, -1], -1), cache
        return step

    def train_cell_step(self, tc: Optional[TrainConfig] = None):
        """A launch cell's training step and its ``opt_init``: ``step(params,
        opt_state, batch, i) -> (params, opt_state, metrics)``."""
        if tc is not None:
            self.tc = tc
            self._train = None
        return self._step, self.opt_init

    # -- derivation / persistence ---------------------------------------------

    def with_overrides(self, *, backend: Optional[str] = None,
                       quant_state=_UNSET, plan=_UNSET,
                       crossbar_model=_UNSET) -> "Runtime":
        """A derived Runtime sharing the model; the plan is shared when its
        (backend, QuantState fingerprint, CrossbarModel fingerprint) still
        matches, else it is re-programmed.  Overrides are literal:
        ``quant_state=None`` means "no registers", ``crossbar_model=None``
        "ideal device"."""
        new_backend = backend or self.backend
        get_backend(new_backend)
        new_qs = self.quant_state if quant_state is _UNSET else quant_state
        new_cm = self.crossbar_model if crossbar_model is _UNSET \
            else crossbar_model
        _check_model_backend(new_backend, new_cm)
        if plan is _UNSET:
            plan_enabled = self._plan_enabled
            if (self.plan is not None and self.plan.backend == new_backend
                    and self.plan.qs_token == quant_state_token(new_qs)
                    and self.plan.cm_token == crossbar_token(new_cm)):
                built = check_plan(self.plan, self.model)
            else:
                built = _build_plan(self.cfg, self.model, new_backend,
                                    new_qs, plan_enabled, new_cm)
        else:
            plan_enabled = plan is True or isinstance(plan, PimPlan)
            built = _build_plan(self.cfg, self.model, new_backend, new_qs,
                                plan, new_cm)
        return Runtime(self.cfg, self.model, backend=new_backend,
                       quant_state=new_qs, plan=built, device=self.device,
                       plan_enabled=plan_enabled, crossbar_model=new_cm,
                       tc=self.tc, mesh=self.mesh,
                       moe_ffn_shard_data=self.moe_ffn_shard_data)

    def save(self, path: str) -> Optional[str]:
        """Snapshot the register file next to a checkpoint (the versioned
        ``quant_state.json`` both packages read); returns the written path,
        or None when the Runtime carries no QuantState."""
        if self.quant_state is None:
            return None
        return save_quant_state(path, self.quant_state)


_IDEAL = CrossbarModel()


def _check_model_backend(backend: str, crossbar_model) -> None:
    """A non-null CrossbarModel on a noise-blind backend would be silently
    ignored: every MVM would run ideal while the caller believes faults
    are injected.  Reject the combination."""
    if (crossbar_model is not None and not crossbar_model.is_null
            and not is_noise_aware(backend)):
        raise ValueError(
            f"crossbar_model carries non-idealities but backend "
            f"{backend!r} is not noise-aware (it would silently ignore "
            f"them); use backend='noisy' (or register_noise_aware)")


def _build_plan(cfg, model, backend: str, quant_state, plan,
                crossbar_model=None):
    """``True`` programs a plan (None when the backend has no prepared
    path); a prebuilt ``PimPlan`` is validated against the backend and the
    QuantState and CrossbarModel fingerprints; anything else is None."""
    if plan is True:
        if not has_prepared(backend):
            return None
        # a plan is replicated: it programs the whole weights
        with sharding.gathered(model):
            return prepare_params(model, cfg, quant_state=quant_state,
                                  backend=backend,
                                  crossbar_model=crossbar_model)
    if isinstance(plan, PimPlan):
        if plan.backend != backend:
            raise ValueError(f"plan was programmed for backend "
                             f"{plan.backend!r} but the Runtime executes "
                             f"{backend!r}")
        if plan.qs_token != quant_state_token(quant_state):
            raise ValueError("plan was programmed against a different "
                             "QuantState than this Runtime executes")
        if plan.cm_token != crossbar_token(crossbar_model):
            raise ValueError("plan was programmed against a different "
                             "CrossbarModel (or fault seed) than this "
                             "Runtime executes")
        return check_plan(plan, model)
    return None


def compile(cfg: ModelConfig, params: Any, *, device=None, mesh=None,
            backend: Optional[str] = None,
            quant_state: Optional[QuantState] = None,
            plan: Any = True,
            crossbar_model: Optional[CrossbarModel] = None,
            tc: Optional[TrainConfig] = None,
            moe_ffn_shard_data: bool = False) -> Runtime:
    """Build a :class:`Runtime` on ``device`` (default ``cuda``; without a
    GPU, ``device="cpu"`` must be given).

    Resolution (explicit argument > ambient context > config default):
    ``mesh`` — the argument, else the active ``use_mesh`` mesh, else none;
    ``backend`` — the argument, else the active ``use_backend`` name, else
    ``cfg.pim_backend``; ``quant_state`` — the argument, else the active
    ``use_quant_state`` register file, else none; ``crossbar_model`` —
    the argument, else the active ``use_crossbar_model`` one.

    ``params`` is a state dict (from ``models.init`` or
    ``convert.from_jax``); its tensors move to the device.  On ``meta``
    tensors with ``device="meta"`` the Runtime is abstract.  On a mesh,
    each parameter becomes a DTensor placed by ``param_pspecs``
    (``moe_ffn_shard_data`` as there).  ``plan=True`` programs the
    weight-stationary plan, a prebuilt ``PimPlan`` is validated, and
    ``False``/``None`` serves dynamically.  ``crossbar_model`` defaults to
    the ambient ``use_crossbar_model`` one; a non-null model on a
    noise-blind backend raises ``ValueError``.  ``tc`` is the training
    configuration of ``opt_init``/``train_step`` (default
    ``TrainConfig()``; train with ``plan=None``).  TF32 is switched off:
    the reference's dots run at full f32 precision."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mesh is None:
        mesh = sharding.active_mesh()
    backend = backend or active_backend() or cfg.pim_backend
    get_backend(backend)
    if quant_state is None:
        quant_state = qs_mod.active_quant_state()
    if crossbar_model is None:
        crossbar_model = active_crossbar_model()
    _check_model_backend(backend, crossbar_model)
    model = build_model(cfg)
    state = {k: v.to(device) for k, v in params.items()}
    if mesh is not None:
        with sharding.use_mesh(mesh):
            specs = sharding.param_pspecs(state, moe_ffn_shard_data)
        state = {k: sharding.place(v, mesh, specs[k])
                 for k, v in state.items()}
        sharding.gather_hooks(model)
    model.load_state_dict(state, assign=True)
    model.eval()
    plan_enabled = plan is True or isinstance(plan, PimPlan)
    built = _build_plan(cfg, model, backend, quant_state, plan,
                        crossbar_model)
    return Runtime(cfg, model, backend=backend, quant_state=quant_state,
                   plan=built, device=device, plan_enabled=plan_enabled,
                   crossbar_model=crossbar_model, tc=tc, mesh=mesh,
                   moe_ffn_shard_data=moe_ffn_shard_data)

"""Training loop (port of ``repro.train.loop``): the loss, the train step
with microbatch accumulation, and the host-side ``Trainer`` with its
straggler watchdog and periodic asynchronous checkpoints.

The reference differentiates its functional forward with
``jax.value_and_grad``; here the forward is the model's own, and
``torch.autograd.grad`` takes the gradients of the parameters that
``train_step`` is given.  ``shardings_for`` gives the specs of the
parameters and of the ZeRO-1 optimizer state on a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..convert import ref_groups, stacked
from ..dist import group
from ..dist.sharding import P, param_pspecs, use_mesh, zero1_upgrade
from .optimizer import lr_schedule, make_optimizer

AUX_LOSS_WEIGHT = 0.01


def token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross entropy in f32, the reference's steps: f32
    logits, a detached max, log-sum-exp, the gold logit.  The reference
    takes the gold logit as a masked sum over the vocabulary (one term is
    nonzero); a gather gives the same value and gradient without the
    (B, S, V) mask."""
    logits = logits.float()
    m = torch.amax(logits, -1, keepdim=True).detach()
    logz = torch.log(torch.sum(torch.exp(logits - m), -1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            aux) -> torch.Tensor:
    """Token-mean cross entropy plus ``0.01 * aux`` (the MoE Switch
    loss)."""
    return torch.mean(token_ce(logits, labels)) + AUX_LOSS_WEIGHT * aux


def split_lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux):
    """:func:`lm_loss` of a forward that holds this rank's block of the
    tokens (``dist.group.split_rows``): ``(loss, value)``.  ``loss``
    carries the gradient, the rank's token sum over every rank's token
    count (its terms' gradient is one device's), plus the Switch loss,
    which is the whole batch's on every rank and whose gradient flows
    through this rank's rows only (``models.moe.switch_loss``); ``value``
    is the loss one device computes, the token mean of every rank's terms
    gathered whole, plus that Switch loss."""
    terms = token_ce(logits, labels)
    ranks = group.split_ranks()
    loss = terms.sum() / (terms.numel() * ranks) + AUX_LOSS_WEIGHT * aux
    value = torch.mean(group.gather_tokens(terms.detach())) + \
        AUX_LOSS_WEIGHT * aux.detach()
    return loss, value


def make_train_step(apply_fn: Callable, cfg: ModelConfig, tc: TrainConfig):
    """Returns ``(train_step, opt_init)``.  ``apply_fn(batch) -> (logits,
    aux)`` runs the model's train-mode forward on the parameters that
    ``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` is given (a dict of the model's own leaf tensors, which the
    step updates in place; on a mesh, DTensors).  With ``tc.microbatch`` below the batch, the
    batch is split into ``nb`` microbatches whose losses and gradients are
    each divided by ``nb`` and summed, as the reference's scan does."""
    opt_init, opt_update = make_optimizer(tc, cfg)
    lr_fn = lr_schedule(tc)

    def loss_and_grads(tensors, batch):
        logits, aux = apply_fn(batch)
        if group.rows_split():
            loss, value = split_lm_loss(logits, batch["labels"], aux)
        else:
            loss = value = lm_loss(logits, batch["labels"], aux)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        return value.detach(), [torch.zeros_like(t) if g is None else g
                                for t, g in zip(tensors, grads)]

    def grads_of(params: dict, batch: dict, shards: int):
        names = list(params)
        tensors = [params[n] for n in names]
        b = batch["tokens"].shape[0]
        micro = tc.microbatch // shards
        if micro and micro < b:
            nb = b // micro
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            acc = [torch.zeros_like(t) for t in tensors]
            for i in range(nb):
                sl = slice(i * micro, (i + 1) * micro)
                mb = {k: v[sl] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(tensors, mb)
                loss = loss + l_i / nb
                acc = [a + g / nb for a, g in zip(acc, g_i)]
            grads = acc
        else:
            loss, grads = loss_and_grads(tensors, batch)
        return loss, dict(zip(names, grads))

    def train_step(params, opt_state, batch, step, shards: int = 1):
        """``shards``: the ranks the batch rows are split over (a
        microbatch is ``tc.microbatch // shards`` of a rank's rows).
        While the rows are split the loss is every rank's token mean
        (:func:`split_lm_loss`)."""
        loss, grads = grads_of(params, batch, shards)
        lr = lr_fn(step).to(loss.device)
        params, opt_state, gnorm = opt_update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step, opt_init


def shardings_for(mesh, state: dict, opt_state: dict, tc: TrainConfig,
                  moe_ffn_shard_data: bool = False, cfg=None):
    """(parameter specs, optimizer-state specs) on ``mesh``: the parameters
    by ``param_pspecs``; each moment by its parameters' spec, ZeRO-1
    upgraded when ``tc.zero1``, a factored ``v`` split into its row spec
    (the last dim's entry dropped) and its column spec (the one before).

    The moments are stacked over layers as the reference's (``cfg`` maps
    the port's names onto its paths; without it the moments are keyed by
    the state's own names).  The port updates a stacked moment layer by
    layer, so its stack dim stays replicated and ZeRO-1 picks the first
    divisible dim after it, where the reference's may pick the stack dim
    itself: the same bytes on every rank, a different block.  A stacked
    group of rank-1 members is updated stacked, so its specs are the
    reference's."""
    with use_mesh(mesh):
        p_specs = param_pspecs(state, moe_ffn_shard_data)
        groups = ref_groups(state, cfg) if cfg is not None else \
            {n: [n] for n in state}

        def opt_spec(spec, shape, lead: int):
            if tc.zero1:
                spec = P(*spec[:lead]) + zero1_upgrade(
                    P(*spec[lead:]), shape[lead:], mesh)
            return P(*spec)

        def build(moments):
            out = {}
            for path, names in groups.items():
                spec = tuple(p_specs[names[0]])
                # a stacked group of rank-1 members updates stacked, one of
                # matrices layer by layer (``optimizer.make_optimizer``)
                on_stack = cfg is not None and stacked(path, cfg)
                lead = 1 if on_stack and state[names[0]].ndim >= 2 else 0
                spec = (None,) * on_stack + spec
                leaf = moments[path]
                if isinstance(leaf, dict):            # factored v
                    rank = leaf["row"].ndim + 1
                    parts = list(spec) + [None] * (rank - len(spec))
                    out[path] = {
                        "row": opt_spec(parts[:-1], leaf["row"].shape, lead),
                        "col": opt_spec(parts[:-2] + parts[-1:],
                                        leaf["col"].shape, lead)}
                else:
                    out[path] = opt_spec(spec, leaf.shape, lead)
            return out

        o_specs = {"step": P(), "m": build(opt_state["m"]),
                   "v": build(opt_state["v"])}
    return p_specs, o_specs


@dataclasses.dataclass
class Trainer:
    """Host-side loop: the straggler watchdog, a history row every
    ``log_every`` steps (and at the last), and an asynchronous checkpoint
    every ``tc.checkpoint_every`` steps in the reference's format (``cfg``
    maps the port's state onto the reference's tree; needed with
    ``ckpt_dir``).  Resume is exact: the data stream is stateless."""
    train_step: Callable
    batch_at: Callable[[int], dict]
    tc: TrainConfig
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    cfg: Optional[ModelConfig] = None

    def run(self, params, opt_state, start_step: int = 0,
            num_steps: Optional[int] = None, on_metrics=None):
        from ..ckpt.checkpoint import save_train_state
        if self.ckpt_dir and self.cfg is None:
            raise ValueError("Trainer(ckpt_dir=...) needs cfg to write the "
                             "reference's checkpoint layout")
        num_steps = num_steps or self.tc.total_steps
        step_times: list = []
        stragglers = []
        history = []
        for step in range(start_step, num_steps):
            t0 = time.perf_counter()
            batch = self.batch_at(step)
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch, step)
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-50:]))
            if len(step_times) > 5 and dt > self.tc.watchdog_factor * med:
                stragglers.append((step, dt, med))
            if step % self.log_every == 0 or step == num_steps - 1:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(loss=loss, step=step, step_time_s=dt)
                history.append(row)
                if on_metrics:
                    on_metrics(row)
            if self.ckpt_dir and self.tc.checkpoint_every and \
                    (step + 1) % self.tc.checkpoint_every == 0:
                save_train_state(self.ckpt_dir, step + 1, params, opt_state,
                                 self.cfg, background=True)
        return params, opt_state, {"history": history,
                                   "stragglers": stragglers,
                                   "median_step_s": float(
                                       np.median(step_times))}

"""AdamW with the reference's large-scale options (port of
``repro.train.optimizer``): a global-norm clip in f32, bias correction,
decoupled weight decay, ``optimizer_dtype="bfloat16"`` moments (the update
math runs in f32) and the Adafactor-style row/column-factored second
moment (``factored_second_moment``).

The reference stacks every layer leaf over periods, and its leaf rules act
on those stacked shapes: decay applies where the stacked leaf has rank >= 2
(a layer's norm scale is ``(P, d)`` there), and ``v`` is factored over the
last two axes where both are at least 8 (so a stacked ``(P, d)`` leaf is
factored across layers once ``P >= 8``).  The port keeps one tensor a
layer, so the optimizer groups its parameters by the reference leaf they
came from (``convert.ref_groups``), decides both rules on the group's
stacked shape, and keeps ``m`` and ``v`` stacked, keyed by the reference's
paths: the optimizer state is the reference's tree.  A group whose members
have rank >= 2 updates member by member through views of its stacked
moments (the factored means run over the last two axes, per layer); a
group of rank-1 members is small and is stacked for its update.

``update`` works in place: the parameters and the state it returns are the
tensors it was given.

On a mesh (``init(params, mesh=..., specs=...)``, the specs of
``train.loop.shardings_for``) the parameters, their gradients and the
moments are DTensors.  A member's update runs in its moments' placement
(ZeRO-1: this rank's share of the data axis) through DTensor's own
operations, and the new value goes back to the parameter's placement; a
stacked group of rank-1 members is small and updates whole.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import TrainConfig
from ..convert import ref_groups, stacked
from ..dist.sharding import assign, whole


def lr_schedule(tc: TrainConfig):
    """step -> learning rate, a 0-dim f32 tensor: linear warmup, then a
    cosine from 1 to 0.1 of ``learning_rate``, in f32 as the reference."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - tc.warmup_steps)
                           / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return tc.learning_rate * warm * (0.1 + 0.9 * cos)
    return lr


def _moment_dtype(tc: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if tc.optimizer_dtype == "bfloat16" \
        else torch.float32


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _stacked_shape(path: str, members, cfg) -> tuple:
    shape = tuple(members[0].shape)
    return (len(members),) + shape if stacked(path, cfg) else shape


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _member(t, i):
    """Member ``i`` of a stacked moment: a view (a DTensor over a view of
    its local block on a mesh, the stack dim being replicated there)."""
    if isinstance(t, dict):
        return {k: _member(v, i) for k, v in t.items()}
    if not _is_dt(t):
        return t[i]
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard(0) for p in t.placements):
        raise ValueError("a stacked moment's stack dim must be replicated")
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in t.placements]
    shape = t.shape[1:]
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def make_optimizer(tc: TrainConfig, cfg):
    """(init(params) -> state, update(grads, state, params, lr) ->
    (params, state, gnorm)).  ``params`` and ``grads`` are dicts keyed by
    the port's state-dict names; ``cfg`` maps them onto the reference's
    stacked leaves.  The state is ``{"step": 0-dim int32, "m": {path:
    tensor}, "v": {path: tensor or {"row", "col"}}}``."""
    mdt = _moment_dtype(tc)

    def init(params: dict, mesh=None, specs=None) -> dict:
        """Zeroed moments; on ``mesh`` each one a DTensor placed by its
        spec in ``specs`` (the optimizer-state specs of
        ``shardings_for``), allocating only this rank's block."""
        from ..dist.sharding import zeros_placed
        m, v = {}, {}

        def zeros(shape, device, spec):
            if mesh is None:
                return torch.zeros(shape, dtype=mdt, device=device)
            return zeros_placed(shape, mdt, device, mesh, spec)

        for path, names in ref_groups(params, cfg).items():
            members = [params[n] for n in names]
            shape = _stacked_shape(path, members, cfg)
            dev = members[0].device
            sm = specs["m"][path] if specs else None
            sv = specs["v"][path] if specs else None
            m[path] = zeros(shape, dev, sm)
            if tc.factored_second_moment and _factored(shape):
                v[path] = {"row": zeros(shape[:-1], dev, sv and sv["row"]),
                           "col": zeros(shape[:-2] + shape[-1:], dev,
                                        sv and sv["col"])}
            else:
                v[path] = zeros(shape, dev, sv)
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": m, "v": v}

    def update(grads: dict, state: dict, params: dict, lr):
        b1, b2 = tc.beta1, tc.beta2
        step = state["step"] + 1
        stepf = step.float()
        c1 = 1 - torch.tensor(b1, dtype=torch.float32,
                              device=stepf.device) ** stepf
        c2 = 1 - torch.tensor(b2, dtype=torch.float32,
                              device=stepf.device) ** stepf
        groups = ref_groups(params, cfg)

        # global-norm clip in f32, leaf by leaf in the reference's order
        gsq = None
        for names in groups.values():
            for n in names:
                s = whole(torch.sum(torch.square(grads[n].float())))
                gsq = s if gsq is None else gsq + s
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if tc.grad_clip > 0 else 1.0
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

        def upd(p, g, m, v, decay: bool):
            """One (stacked or single) leaf: returns (p_new, m_new, v_new),
            v_new a {"row", "col"} dict where v is."""
            g = g.float() * scale
            m_new = b1 * m.float() + (1 - b1) * g
            if isinstance(v, dict):                  # factored second moment
                g2 = torch.square(g) + 1e-30
                vr = b2 * v["row"].float() + (1 - b2) * g2.mean(-1)
                vc = b2 * v["col"].float() + (1 - b2) * g2.mean(-2)
                v_hat = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=1e-30))
                v_new = {"row": vr, "col": vc}
            else:
                v_hat = b2 * v.float() + (1 - b2) * torch.square(g)
                v_new = v_hat
            upd_ = (m_new / c1) / (torch.sqrt(v_hat / c2) + tc.eps)
            if decay:                               # decoupled weight decay
                upd_ = upd_ + tc.weight_decay * p.float()
            return (p.float() - lr * upd_).to(p.dtype), m_new, v_new

        def store(dst, src):
            if isinstance(dst, dict):
                dst["row"].copy_(src["row"])
                dst["col"].copy_(src["col"])
            else:
                dst.copy_(src)

        def member(v, i):
            if isinstance(v, dict):
                return {"row": v["row"][i], "col": v["col"][i]}
            return v[i]

        with torch.no_grad():
            for path, names in groups.items():
                m, v = state["m"][path], state["v"][path]
                members = [params[n] for n in names]
                shape = _stacked_shape(path, members, cfg)
                decay = len(shape) >= 2
                if _is_dt(m):
                    _update_placed(upd, path, names, members, grads, m, v,
                                   decay)
                elif not stacked(path, cfg):
                    p_new, m_new, v_new = upd(members[0], grads[names[0]],
                                              m, v, decay)
                    members[0].copy_(p_new)
                    m.copy_(m_new)
                    store(v, v_new)
                elif members[0].ndim >= 2:
                    # per layer: every rule acts on the last two axes, so
                    # a rank-3 member (an expert bank) goes expert by
                    # expert: the same values, and temporaries of one
                    # expert's size
                    for i, (p, n) in enumerate(zip(members, names)):
                        for j in (range(len(p)) if p.ndim >= 3
                                  else (slice(None),)):
                            vi = member(member(v, i), j)
                            p_new, m_new, v_new = upd(p[j], grads[n][j],
                                                      m[i][j], vi, decay)
                            p[j].copy_(p_new)
                            m[i][j].copy_(m_new)
                            store(vi, v_new)
                else:
                    # rank-1 layer leaves: factored across layers, stacked
                    p_new, m_new, v_new = upd(
                        torch.stack(members),
                        torch.stack([grads[n] for n in names]), m, v, decay)
                    for i, p in enumerate(members):
                        p.copy_(p_new[i])
                    m.copy_(m_new)
                    store(v, v_new)
        state["step"] = step
        return params, state, gnorm

    def _update_placed(upd, path, names, members, grads, m, v, decay):
        """The mesh branch of ``update`` (see the module docstring)."""
        from torch.distributed.tensor.experimental import \
            implicit_replication
        if stacked(path, cfg) and members[0].ndim < 2:
            p_new, m_new, v_new = upd(
                torch.stack([whole(p) for p in members]),
                torch.stack([whole(grads[n]) for n in names]),
                whole(m), {k: whole(x) for k, x in v.items()}
                if isinstance(v, dict) else whole(v), decay)
            for i, p in enumerate(members):
                assign(p, p_new[i])
            assign(m, m_new)
            assign(v, v_new)
            return
        for i, (p, n) in enumerate(zip(members, names)):
            j = i if stacked(path, cfg) else None
            mi = m if j is None else _member(m, j)
            vi = v if j is None else _member(v, j)
            pl = mi.placements
            with implicit_replication():
                p_new, m_new, v_new = upd(
                    p.redistribute(p.device_mesh, pl),
                    grads[n].redistribute(p.device_mesh, pl), mi, vi,
                    decay)
            assign(mi, m_new)
            assign(vi, v_new)
            assign(p, p_new)

    return init, update

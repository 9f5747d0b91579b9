"""Mixture-of-Experts FFN: top-k routing and capacity-bounded dispatch
(port of ``repro.models.moe``).

Tokens form groups of ``min(moe_group_size, S)``; each group routes its
tokens to the top ``experts_per_token`` of ``n_experts`` experts by f32
router probabilities, renormalised over the chosen k.  Every expert has
``cap = round(group * k * capacity_factor / E)`` slots a group (Python's
``round``: a half goes to the even side), filled in routing order (token
by token, a token's choices in rank order); a choice past its expert's
capacity is dropped and the residual carries the token.  A Switch-style
load-balancing loss is returned beside the output, over the whole batch:
while a mesh splits the rows (``dist.group.split_rows``) its two means
are summed over the ranks (:func:`switch_loss`).

The router, dispatch, expert FFNs and combine are plain tensor ops, as the
reference's are plain ``jnp``: the expert FFNs do not go through
``pim_linear`` (no plan, no A/D conversions).  The expert products are one
batched product over experts on the stacked ``(E, d, d_ff)`` weights, over
every expert's ``cap`` slots, empty ones too, as the reference computes
them.  Dispatch gathers each slot's token through an inverse slot map, so
no result depends on the order of colliding writes (only the discarded
overflow column takes more than one).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..dist import group


def capacity(group: int, k: int, capacity_factor: float, e: int) -> int:
    """Slots per expert and group, as the reference computes them (the
    same float expression, then Python's half-to-even ``round``)."""
    return int(max(1, round(group * k * capacity_factor / e)))


def route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """x (..., D) -> (probs (..., E), gate (..., k), idx (..., k) int64).

    Router logits at f32 or wider, softmax, then the top k in descending
    order with the lower expert index first among equal probabilities (a
    stable sort; ``torch.topk`` leaves ties unspecified), renormalised by
    ``max(sum, 1e-9)``."""
    rdt = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(rdt) @ router_w.to(rdt)
    probs = torch.softmax(logits, -1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], order[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def slot_positions(idx: torch.Tensor, e: int, cap: int):
    """idx (g, T) expert choices in routing order -> (slot (g, T), the
    index of each choice in its expert's ``cap`` slots, or ``cap`` where
    it overflows; dropped (g, T) bool)."""
    onehot_cum = nn.functional.one_hot(idx, e).cumsum(1)
    pos = onehot_cum.gather(-1, idx[..., None])[..., 0] - 1
    dropped = pos >= cap
    return torch.where(dropped, torch.full_like(pos, cap), pos), dropped


def switch_loss(probs: torch.Tensor, idx: torch.Tensor,
                e: int) -> torch.Tensor:
    """``E * sum_e me_e * ce_e``: ``me`` the mean router probability of
    expert e, ``ce`` the share of the choices that pick it, both over the
    whole batch.  While the rows are split each rank's sums are added
    over the split axes (one all-reduce) and divided by the whole counts,
    so every rank holds the same value; the gradient flows through this
    rank's own probabilities only (the others' enter detached), so the
    ranks' gradients sum to one device's."""
    prob_sum = probs.sum(dim=(0, 1))
    flat = idx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))    # bincount's
    if not group.rows_split():
        me = probs.mean(dim=(0, 1))
        ce = counts.to(probs.dtype) / float(idx.numel())
    else:
        tot = group.global_sum(torch.cat([prob_sum.double(),
                                          counts.double()]))
        n_choices = tot[e:].sum()
        rows = n_choices / idx.shape[-1]
        me = (tot[:e] / rows).to(probs.dtype) + \
            (prob_sum - prob_sum.detach()) / rows.to(probs.dtype)
        ce = (tot[e:] / n_choices).to(probs.dtype)
    return (e * torch.sum(me * ce)).float()


def apply_moe(moe: "MoE", x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss f32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    group = min(cfg.moe_group_size, s)
    g = (b * s) // group
    xt = x.reshape(g, group, d)

    probs, gate, idx = route(xt, moe.router.w, k)
    aux = switch_loss(probs, idx, e)

    cap = capacity(group, k, cfg.capacity_factor, e)
    flat_idx = idx.reshape(g, group * k)                  # routing order
    slot, dropped = slot_positions(flat_idx, e, cap)

    # dispatch: the inverse slot map names the token in each of the E * cap
    # slots (``group``, a zero row, where none is); dropped choices write to
    # one discarded column past the slots
    dump = e * cap
    target = torch.where(dropped, torch.full_like(slot, dump),
                         flat_idx * cap + slot)
    token = torch.arange(group * k, device=x.device).div(
        k, rounding_mode="floor").expand(g, -1)
    inv = torch.full((g, dump + 1), group, dtype=torch.int64,
                     device=x.device)
    inv.scatter_(1, target, token)
    xz = torch.cat([xt, xt.new_zeros(g, 1, d)], 1)
    buf = xz.gather(1, inv[:, :dump, None].expand(-1, -1, d))  # (g, E*cap, D)

    # expert FFN (gated SiLU): one batched product over experts
    bufe = buf.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h_g = torch.bmm(bufe, moe.w_gate.to(bufe.dtype))
    h_u = torch.bmm(bufe, moe.w_up.to(bufe.dtype))
    h = h_g * torch.sigmoid(h_g) * h_u
    out_e = torch.bmm(h, moe.w_down.to(bufe.dtype))       # (E, g*cap, D)
    out_e = out_e.reshape(e, g, cap, d).transpose(0, 1).reshape(g, dump, d)

    # combine: each kept choice's expert output back to its token, weighted
    # by its gate in the compute dtype
    keep = torch.where(dropped, torch.zeros_like(target), target)
    picked = out_e.gather(1, keep[..., None].expand(-1, -1, d))
    picked = torch.where(dropped[..., None], picked.new_zeros(()), picked)
    picked = picked.reshape(g, group, k, d)
    out = torch.einsum("gskd,gsk->gsd", picked, gate.to(picked.dtype))
    return out.reshape(b, s, d), aux


class Router(nn.Module):
    def __init__(self, d: int, e: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, e, dtype=torch.float32,
                                          device=device),
                              requires_grad=False)


class MoE(nn.Module):
    """Leaves ``router.w`` (d, E) f32 and the stacked expert weights
    ``w_gate``, ``w_up`` (E, d, d_ff) and ``w_down`` (E, d_ff, d) in the
    parameter dtype, as the reference names them.  ``forward(x)`` returns
    ``(out, aux_loss)``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        f = cfg.moe_d_ff or cfg.d_ff
        e, d = cfg.n_experts, cfg.d_model
        self.router = Router(d, e, device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)

    def forward(self, x: torch.Tensor):
        return apply_moe(self, x, self.cfg)

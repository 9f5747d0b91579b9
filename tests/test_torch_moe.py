"""Parity of the port's MoE (``repro_torch.models.moe`` and the MoE layer
kinds of ``models.lm``, ``models.registry`` and ``convert``) with the JAX
reference ``repro.models.moe``.

The same seeded numpy inputs go through both packages, with the
reference's own weights (``convert.from_jax``).  Compute is f32 (bf16
``fake_quant`` does not run on JAX's CPU backend).  Bars: the MoE module's
output at rtol=atol=1e-5 and its aux loss at 1e-6, with the chosen experts
equal, at a decode shape and at prefill shapes with drops (S = 8 gives a
capacity of 2.5, which Python's ``round`` takes to 2 and a half-up rounding
to 3).  Whole models: logits at the bars of ``tests/test_torch_model.py``
(1e-4 on ``exact``, 1e-3 on the quantized datapaths) and A/D ops equal to
the reference's and to the attention projections' count alone (the expert
FFNs do not go through ``pim_linear``).

A different f32 summation order (attention, the router) can flip one
expert choice whose two probabilities lie within an ulp, and that moves a
token's output by a whole expert; the inputs here are fixed and cross no
such margin.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import _flatten, _tensor, from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.registry import ARCHS, get_config, init  # noqa: E402
from repro_torch.pim.plan import iter_linears  # noqa: E402

ARCH = "granite-moe-3b-a800m"
ARCTIC = "arctic-480b"
F32 = dict(remat="none", dtype="float32")
TOL = {"exact": 1e-4, "fake_quant": 1e-3, "pallas": 1e-3, "bit_exact": 1e-3}


@pytest.fixture
def rng():
    """A fresh stream per test: each test's inputs are fixed whatever runs
    before it."""
    return np.random.default_rng(2024)


def _cfgs(arch=ARCH, **kw):
    return (jget_config(arch, smoke=True).replace(**F32, **kw),
            get_config(arch, smoke=True).replace(**F32, **kw))


def _moe_pair(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    mod = moe.MoE(tcfg, torch.float32, device="meta")
    mod.load_state_dict({path: _tensor(leaf) for path, leaf in _flatten(
        jax.tree.map(np.asarray, p))}, assign=True)
    return jcfg, tcfg, p, mod


def _ref_route(p, x, cfg):
    """The reference's routing (``apply_moe``'s first lines): the chosen
    experts of every token of ``x`` (B, S, D), in group order."""
    b, s, d = x.shape
    group = min(cfg.moe_group_size, s)
    xt = jnp.asarray(x).reshape((b * s) // group, group, d)
    logits = jnp.einsum("gsd,de->gse", xt.astype(jnp.float32),
                        p["router"]["w"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1),
                           cfg.experts_per_token)
    return np.asarray(idx)


# ---------------------------------------------------------------------------
# the MoE module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 1), (2, 8), (2, 40), (1, 128)],
                         ids=["decode", "s8-half-even", "s40-half-even",
                              "two-groups"])
def test_moe_matches_reference(rng, shape):
    """Output at 1e-5, aux loss at 1e-6, the same experts; the prefill
    shapes drop choices (asserted), with capacities at a half (2.5 -> 2,
    12.5 -> 12) and over two groups of 64 tokens."""
    jcfg, tcfg, p, mod = _moe_pair()
    b, s = shape
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.apply_moe(p, jnp.asarray(x), jcfg)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, aux = mod(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    assert aux.dtype == torch.float32

    group = min(tcfg.moe_group_size, s)
    _, _, idx = moe.route(xt.reshape(-1, group, tcfg.d_model),
                          mod.router.w, tcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), _ref_route(p, x, jcfg))
    cap = moe.capacity(group, tcfg.experts_per_token, tcfg.capacity_factor,
                       tcfg.n_experts)
    _, dropped = moe.slot_positions(idx.reshape(idx.shape[0], -1),
                                    tcfg.n_experts, cap)
    assert bool(dropped.any()) == (s > 1)


def test_capacity_rounds_a_half_to_even():
    """The reference's ``int(max(1, round(...)))``: 2.5 -> 2, 12.5 -> 12,
    3.5 -> 4, a quarter -> 1 (granite's decode), 16 at granite's 64-token
    bucket."""
    assert moe.capacity(8, 2, 1.25, 8) == 2
    assert moe.capacity(40, 2, 1.25, 8) == 12
    assert moe.capacity(56, 2, 1.25, 10) == 14
    assert moe.capacity(28, 2, 1.25, 10) == 7
    assert moe.capacity(1, 8, 1.25, 40) == 1
    assert moe.capacity(64, 8, 1.25, 40) == 16
    assert moe.capacity(16, 8, 1.25, 40) == 4
    for group in range(1, 200):
        x = group * 2 * 1.25 / 8
        assert moe.capacity(group, 2, 1.25, 8) == int(max(1, round(x)))


def test_ties_take_the_lower_expert_first(rng):
    """Equal probabilities (duplicated router columns, and zero rows: the
    left-pad tokens, whose probabilities are all equal) route to the lower
    expert index first, as ``jax.lax.top_k`` does, through the whole
    dispatch."""
    jcfg, tcfg, p, mod = _moe_pair()
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 1]
    p = dict(p, router={"w": jnp.asarray(w)})
    mod.router.w.data = torch.from_numpy(w)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    x[0, :3] = 0.0
    _, _, idx = moe.route(torch.from_numpy(x).reshape(2, 8, -1),
                          mod.router.w, tcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), _ref_route(p, x, jcfg))
    np.testing.assert_array_equal(idx[0, :3].numpy(), [[0, 1]] * 3)
    want, want_aux = jmoe.apply_moe(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)


def test_slot_positions_fill_each_expert_in_routing_order(rng):
    """Each choice takes its expert's next slot in routing order; the
    choices past the capacity are dropped and take the overflow slot."""
    _, tcfg, _, mod = _moe_pair()
    e, k = tcfg.n_experts, tcfg.experts_per_token
    idx = torch.from_numpy(rng.integers(0, e, (3, 16 * k)))
    slot, dropped = moe.slot_positions(idx, e, 3)
    for g in range(3):
        seen = {}
        for t in range(idx.shape[1]):
            ex = int(idx[g, t])
            want = seen.get(ex, 0)
            seen[ex] = want + 1
            assert int(slot[g, t]) == min(want, 3)
            assert bool(dropped[g, t]) == (want >= 3)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    params = jbuild(_cfgs()[0])[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _rt_pair(params, backend, arch=ARCH, **kw):
    jcfg, tcfg = _cfgs(arch, pim_backend=backend, **kw)
    rj = jrt.compile(jcfg, params[0])
    rt = trt.compile(tcfg, from_jax(params[1], tcfg), device="cpu")
    return rj, rt


def _planned_conversions(rt) -> int:
    """Conversions of one token row: N x ceil(K/128) over every planned
    projection (wq, wk, wv, wo of each layer; no expert, no router)."""
    return sum(lin.w.shape[1] * -(-lin.w.shape[0] // 128)
               for _, lin in iter_linears(rt.model))


@pytest.mark.parametrize("backend", ["exact", "fake_quant", "pallas",
                                     "bit_exact"])
def test_serve_entry_points_match_reference(jax_params, rng, backend):
    """Prefill of 8 tokens (batch 2), a continued prefill of 8 more, and a
    decode step: logits within the bar, A/D ops equal to the reference's
    and to 7 ops (x 64 bit-line conversions on ``bit_exact``) per
    conversion of the attention projections."""
    rj, rt = _rt_pair(jax_params, backend)
    toks = rng.integers(0, rt.cfg.vocab_size, (2, 16)).astype(np.int32)
    tol = TOL[backend]
    per_row = 7 * _planned_conversions(rt) * (
        64 if backend == "bit_exact" else 1) * (backend != "exact")

    def check(got, want, rows):
        (lt, _), rept = got
        (lj, _), repj = want
        np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj),
                                   rtol=tol, atol=tol)
        assert rept.total() == float(repj.ad_ops) == per_row * rows

    (lj, cj), repj = rj.prefill(toks[:, :8], max_len=16)
    (lt, ct), rept = rt.prefill(toks[:, :8], max_len=16)
    check(((lt, ct), rept), ((lj, cj), repj), 16)
    pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32), (2, 8))
    check(rt.prefill_cont(toks[:, 8:], pos, ct),
          rj.prefill_cont(toks[:, 8:], pos, cj), 16)
    check(rt.decode(toks[:, :1], ct), rj.decode(toks[:, :1], cj), 2)


def test_train_mode_logits_match_reference(jax_params, rng):
    rj, rt = _rt_pair(jax_params, "exact")
    toks = rng.integers(0, rt.cfg.vocab_size, (2, 12)).astype(np.int32)
    (lj, _, _), _ = rj.apply({"tokens": toks})
    (lt, _, _), _ = rt.apply({"tokens": toks})
    assert lt.shape == (2, 12, rt.cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


def test_train_mode_apply_returns_the_reference_switch_loss(jax_params,
                                                            rng):
    """``Runtime.apply`` in train mode returns the Switch loss summed over
    the MoE layers in layer order (f32, nonzero) as the reference's
    ``apply``; a dense model returns 0.0 in f32, as the reference."""
    rj, rt = _rt_pair(jax_params, "exact")
    toks = rng.integers(0, rt.cfg.vocab_size, (2, 12)).astype(np.int32)
    (_, _, aux_j), _ = rj.apply({"tokens": toks})
    (_, _, aux_t), _ = rt.apply({"tokens": toks})
    assert aux_t.dtype == torch.float32 and aux_t.ndim == 0
    assert float(aux_j) > 0.5
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    dense = get_config("llama3.2-3b", smoke=True).replace(**F32)
    rd = trt.compile(dense, init(dense, seed=0, device="cpu"), device="cpu")
    (_, _, aux_d), _ = rd.apply({"tokens": toks})
    assert aux_d.dtype == torch.float32 and float(aux_d) == 0.0


def test_plan_holds_the_attention_projections_only(jax_params):
    """The plan, the A/D count and the census see ``wq/wk/wv/wo`` of each
    layer: 4 x 2 at the smoke config, no expert or router path."""
    _, rt = _rt_pair(jax_params, "pallas")
    paths = sorted(rt.plan.layers)
    assert len(paths) == 4 * rt.cfg.n_layers
    assert all(".attn.w" in p for p in paths)
    assert {n.rsplit(".", 1)[0] for n, _ in iter_linears(rt.model)} == \
        {f"layers.{i}.attn" for i in range(rt.cfg.n_layers)}


def test_from_jax_round_trips_every_moe_leaf(jax_params):
    """``periods/layer_0/moe/{router/w, w_gate, w_up, w_down}`` become
    ``layers.{i}.moe.*`` with the reference's values, shapes and dtypes,
    and the keys equal the model's state dict."""
    _, params_np = jax_params
    cfg = _cfgs()[1]
    state = from_jax(params_np, cfg)
    assert set(state) == set(LM(cfg, device="meta").state_dict())
    per = params_np["periods"]["layer_0"]["moe"]
    for i in range(cfg.n_layers):
        for path, leaf in (("router.w", per["router"]["w"][i]),
                           ("w_gate", per["w_gate"][i]),
                           ("w_up", per["w_up"][i]),
                           ("w_down", per["w_down"][i])):
            got = state[f"layers.{i}.moe.{path}"]
            assert tuple(got.shape) == leaf.shape
            assert str(got.dtype).split(".")[-1] == str(leaf.dtype)
            np.testing.assert_array_equal(got.numpy(), leaf)


def test_init_draws_the_reference_moe_leaves():
    """Shapes and dtypes of the reference's ``init_moe`` at bf16
    parameters, the scales N(0, 1) * d**-0.5 (``w_gate``, ``w_up``, the
    router) and * d_ff**-0.5 (``w_down``), and a router held in f32 whose
    values are exact in bf16."""
    jcfg = jget_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = dict(_flatten(jax.tree.map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))))
    got = init(cfg, seed=0, device="cpu")
    d, f = cfg.d_model, cfg.d_ff
    for path, want in ref.items():
        leaf = got[f"layers.1.moe.{path}"]
        assert tuple(leaf.shape) == want.shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path
        scale = f ** -0.5 if path == "w_down" else d ** -0.5
        assert abs(float(leaf.float().std()) / scale - 1.0) < 0.1, path
    router = got["layers.1.moe.router.w"]
    assert torch.equal(router, router.bfloat16().float())


# ---------------------------------------------------------------------------
# arctic: the MoE beside a dense MLP (dense residual)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def arctic_params():
    params = jbuild(_cfgs(ARCTIC)[0])[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def test_arctic_moe_plus_mlp_layers_match_reference(arctic_params, rng):
    """arctic's ``("attn", "moe+mlp")`` layers, ``(x + moe) + mlp``, at its
    smoke config on ``pallas``: prefill and decode logits within the bar,
    A/D ops equal (the dense MLP's projections are planned, the experts'
    are not)."""
    assert ARCTIC in ARCHS
    rj, rt = _rt_pair(arctic_params, "pallas", ARCTIC)
    assert [(layer.mixer, layer.ffn) for layer in rt.model.layers] == \
        [("attn", "moe+mlp")] * rt.cfg.n_layers
    assert len(rt.plan) == 7 * rt.cfg.n_layers + 1     # the untied lm_head
    toks = rng.integers(0, rt.cfg.vocab_size, (2, 8)).astype(np.int32)
    (lj, cj), repj = rj.prefill(toks, max_len=16)
    (lt, ct), rept = rt.prefill(toks, max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-3,
                               atol=1e-3)
    assert rept.total() == float(repj.ad_ops) > 0
    (lj, _), repj = rj.decode(toks[:, :1], cj)
    (lt, _), rept = rt.decode(toks[:, :1], ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-3,
                               atol=1e-3)
    assert rept.total() == float(repj.ad_ops)

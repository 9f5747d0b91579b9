"""Parity of the port's train step on jamba-v0.1-52b (the mamba scan, the
causal depthwise conv, the softplus coefficients and the MoE layers with
their Switch loss) with the JAX reference, at the smoke config in f32.
The harness is ``tests/test_torch_train.py``'s: the reference's step 3
from its parameters and optimizer state after steps 0-2, through the
reference ``Runtime``'s jitted step (one compile a case, 25-50 s on a
CPU).  Bars: ``tests/test_torch_train.py``'s.

On ``exact`` the whole step is held.  On ``fake_quant`` the whole model
cannot be: an f32 ulp of another summation order puts a partial sum on
the other side of a quantizer step now and then, and the step reaches the
carried state ``h``, every later row through the dynamic scales, and the
top-2 router, where a changed expert choice moves the loss by up to 1 %.
Seeds 0-2 at 2 x 8 tokens are 390-412x the bar on an expert leaf, the
losses 1.3e-3 to 7.9e-3 apart.  So ``fake_quant`` is held layer by layer:
the ``mamba+mlp`` layer 0 and the ``mamba+moe`` layer 1, forward and
backward on the reference's own input to the layer, with the router's
choices asserted equal, so that a gap left is not a flip.  At seed 1 the
gap starts in one element of layer 0's ``in_proj``, one coarse step
apart on identical inputs: a flip, pinned by its own test; layer 1 holds
there.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train import (TC, STEP, _cfgs, _conversions,  # noqa: E402
                              _port_step, _warm_case)
from test_torch_train_rwkv6_whisper import (  # noqa: E402
    _assert_step_close, assert_checkpoint_round_trip, run_cli_with_resume)
from repro import runtime as jrt  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import from_jax, opt_from_jax  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.moe import route  # noqa: E402

JAMBA = "jamba-v0.1-52b"
EXACT = (1, 4, 32)                # (seed, batch, seq)
FLIPPED = (1, 2, 8)               # the whole-model fake_quant outlier


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (``tests/test_torch_train.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_step_matches_reference():
    """``exact``: loss and gnorm at rtol 1e-5, lr equal, every parameter at
    rtol 1e-5, atol 1e-6 (decay on the stacked rank-1 leaves ``a_log``,
    ``d``, ``dt_bias`` and the norms, ``n_periods = 1``), ad_ops 0 on both."""
    c, want_p, want_m = _warm_case(JAMBA, "exact", *EXACT)
    _, got_p, got_m, rep = _port_step(c)
    np.testing.assert_allclose(float(got_m["loss"]), want_m["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["gnorm"]), want_m["gnorm"],
                               rtol=1e-5)
    assert float(got_m["lr"]) == want_m["lr"]
    _assert_step_close(c, got_p, want_p, want_m["lr"])
    assert rep.total() == float(got_m["ad_ops"]) == want_m["ad_ops"] == 0


# ---------------------------------------------------------------------------
# fake_quant, layer by layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_layer(jcfg, idx: int):
    """The reference's layer ``idx`` (``_apply_layer``), jitted: (params
    of the layer, input x, cotangent of the output) -> (output, Switch
    loss, gradient of sum(output * cotangent) + Switch loss by the layer's
    params and by x, the router's top-k choices or None)."""
    from repro.models.layers import rmsnorm
    from repro.models.lm import _apply_layer
    from repro.models.mamba import apply_mamba
    from repro.pim.backend import use_backend

    def run(lp, x, ct):
        b, s, _ = x.shape
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None],
                                     (b, s))
        with use_backend(jcfg.pim_backend):
            def fwd(lp_, x_):
                y, _, aux = _apply_layer(lp_, x_, jcfg, idx, positions,
                                         None, jnp.float32(0))
                return y, aux
            (y, aux), vjp = jax.vjp(fwd, lp, x)
            g_lp, g_x = vjp((ct, jnp.ones((), jnp.float32)))
            choice = None
            if "moe" in lp:
                h = rmsnorm(lp["norm1"], x, jcfg.norm_eps)
                o, _ = apply_mamba(lp["mamba"], h, jcfg,
                                   prefix=f"layer_{idx}/mamba")
                h2 = rmsnorm(lp["norm2"], x + o, jcfg.norm_eps)
                probs = jax.nn.softmax(h2.astype(jnp.float32)
                                       @ lp["moe"]["router"]["w"], -1)
                choice = jax.lax.top_k(probs, jcfg.experts_per_token)[1]
        return y, aux, g_lp, g_x, choice
    return jax.jit(run)


def _layer_params(params: dict, idx: int) -> dict:
    """Layer ``idx`` of the reference's tree (one period at smoke)."""
    return jax.tree.map(lambda t: t[0], params["periods"][f"layer_{idx}"])


def _flat_paths(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_paths(v, path)
        else:
            yield path, v


def _layer_input(c, tokens, idx: int):
    """The reference's input to layer ``idx`` (its embedding, then its
    ``fake_quant`` layers before ``idx``) and the seeded cotangents of
    layers 0..idx: (x, the last cotangent, the reference's results)."""
    from repro.models.layers import embed
    jcfg = _cfgs(JAMBA, "fake_quant")[0]
    x = np.asarray(embed(c.params["embed"], tokens), np.float32)
    rng = np.random.default_rng(idx)
    for i in range(idx + 1):
        ct = rng.standard_normal(x.shape).astype(np.float32)
        out = _ref_layer(jcfg, i)(_layer_params(c.params, i), x, ct)
        if i < idx:
            x = np.asarray(out[0])
    return x, ct, out


def _state(name: str):
    """(case, tokens) of a per-layer state: ``tokens0`` takes the weights
    of the ``exact`` case and the 2 x 8 tokens of the stream's seed 0 at
    the compared step; ``seed1`` the ``fake_quant`` case at 2 x 8, seed 1
    (its weights and batch), whose whole-model losses are 7.9e-3 apart."""
    if name == "seed1":
        c = _warm_case(JAMBA, "fake_quant", *FLIPPED)[0]
        return c, c.batch["tokens"]
    c = _warm_case(JAMBA, "exact", *EXACT)[0]
    stream = JTokenStream(c.jcfg.vocab_size, 8, 2, seed=0)
    return c, np.asarray(stream.batch_at(STEP)["tokens"])


@pytest.mark.parametrize("state, idx", [("tokens0", 0), ("tokens0", 1),
                                        ("seed1", 1)],
                         ids=["tokens0-mamba+mlp", "tokens0-mamba+moe",
                              "seed1-mamba+moe"])
def test_fake_quant_layer_matches_reference(state, idx):
    """One ``fake_quant`` layer on the reference's input to it and a
    seeded cotangent: the output and the Switch loss at rtol 1e-5, atol
    1e-6; the gradient by x and by every parameter of the layer at rtol
    1e-5 with an atol of 1e-5 of the leaf's largest gradient (a gradient
    sums many terms of both signs: two summation orders leave up to 1.5e-6
    of the largest); the router's top-2 choices equal.  (Layer 0 at
    ``seed1`` crosses a quantizer step:
    ``test_seed1_gap_is_one_quantizer_step``.)"""
    c, tokens = _state(state)
    x, ct, (y, aux, g_lp, g_x, choice) = _layer_input(c, tokens, idx)
    tcfg = _cfgs(JAMBA, "fake_quant")[1]
    rt = trt.compile(tcfg, from_jax(c.params, tcfg), device="cpu",
                     plan=None)
    layer = rt.model.layers[idx]
    named = dict(layer.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    seen = {}

    def moe_input(mod, args):
        seen["h"] = args[0].detach()
    if layer.ffn == "moe":
        layer.moe.register_forward_pre_hook(moe_input)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    yt, _, auxt = layer(xt, rt._ctx(), positions)
    auxt = torch.zeros(()) if auxt is None else auxt
    loss = torch.sum(yt * torch.from_numpy(ct)) + auxt
    grads = torch.autograd.grad(loss, [xt, *named.values()])
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(auxt.detach()), float(aux), rtol=1e-5,
                               atol=1e-6)
    want = dict(_flat_paths(g_lp), x=g_x)
    assert set(want) == set(named) | {"x"}
    for name, g in zip(["x", *named], grads):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    if layer.ffn == "moe":
        assert float(aux) > 0.5
        _, _, idx_t = route(seen["h"], layer.moe.router.w,
                            tcfg.experts_per_token)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(choice))


def test_seed1_gap_is_one_quantizer_step():
    """At ``seed1`` the whole-model gap starts in layer 0's ``in_proj``:
    on the reference's own input (its norm of the embedding), the two
    packages' ``fake_quant`` outputs differ in one element of 8,192, by
    one coarse quantizer step (``delta_r2`` times the grid: a partial sum
    an ulp of summation order from a step), and agree at rtol 1e-5, atol
    1e-6 elsewhere.  The layer's dynamic scales then carry the step to
    every later projection: a flip, not a fault."""
    from repro.models.layers import embed, pim_linear, rmsnorm
    from repro.pim.backend import use_backend
    from repro_torch.models.layers import trq_params_from_cfg
    from repro_torch.pim.backend import _dynamic_scales, grid_scale
    from repro_torch.pim.crossbar import auto_range_fit
    c, tokens = _state("seed1")
    jcfg, tcfg = _cfgs(JAMBA, "fake_quant")
    lp = _layer_params(c.params, 0)

    @jax.jit
    def ref(lp, tokens):
        with use_backend("fake_quant"):
            h = rmsnorm(lp["norm1"], embed(c.params["embed"], tokens),
                        jcfg.norm_eps)
            return h, pim_linear(lp["mamba"]["in_proj"], h, jcfg,
                                 name="layer_0/mamba/in_proj")
    h, want = (np.asarray(t) for t in ref(lp, tokens))
    rt = trt.compile(tcfg, from_jax(c.params, tcfg), device="cpu",
                     plan=None)
    lin = rt.model.layers[0].mamba.in_proj
    ht = torch.from_numpy(h.copy())
    with torch.no_grad():
        got = lin(ht, rt._ctx()).numpy()
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert int(off.sum()) == 1
    grid = grid_scale(*_dynamic_scales(ht, lin.w, None, None),
                      tcfg.trq.delta_grid, "cpu")
    fit = auto_range_fit(ht, lin.w, trq_params_from_cfg(tcfg.trq), grid)
    assert float(np.abs(got - want)[off][0]) == pytest.approx(
        float(fit.delta_r2 * grid), rel=1e-4)


# ---------------------------------------------------------------------------
# the Switch loss, remat, checkpoints, the CLI
# ---------------------------------------------------------------------------

def test_switch_loss_enters_the_step():
    """The MoE layers' Switch loss on the step's parameters and batch:
    nonzero and equal to the reference's ``apply`` at rtol 1e-6, and the
    step's loss less the port's cross entropy is 0.01 of it."""
    c, _, want_m = _warm_case(JAMBA, "exact", *EXACT)
    rj = jrt.compile(c.jcfg, c.params, plan=None)
    (logits_j, _, aux_j), _ = rj.apply({"tokens": c.batch["tokens"]})
    rt = trt.compile(c.tcfg, from_jax(c.params, c.tcfg), device="cpu",
                     plan=None)
    (logits_t, _, aux_t), _ = rt.apply({"tokens": c.batch["tokens"]})
    assert float(aux_j) > 0.5
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    from repro_torch.train.loop import lm_loss
    ce = float(lm_loss(logits_t, torch.tensor(c.batch["labels"]), 0.0))
    assert want_m["loss"] == pytest.approx(ce + 0.01 * float(aux_t),
                                           rel=1e-5)


def test_remat_block_is_remat_none():
    """``remat="block"`` against ``"none"`` on ``fake_quant``: the same
    loss, the parameters within 1 ulp, the same ad_ops (each conversion
    counted once: 7 a conversion of every row); every layer is entered
    twice."""
    c, _, _ = _warm_case(JAMBA, "exact", *EXACT)
    c = type(c)(*_cfgs(JAMBA, "fake_quant"), c.params, c.opt, c.batch)
    _, p_none, m_none, _ = _port_step(c)
    tcfg = c.tcfg.replace(remat="block")
    rt = trt.compile(tcfg, from_jax(c.params, tcfg), device="cpu",
                     plan=None, tc=TrainConfig(**TC))
    calls = []
    for layer in rt.model.layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    (p_block, _, m_block), rep = rt.train_step(
        rt.params, opt_from_jax(c.opt), c.batch, STEP)
    assert len(calls) == 2 * len(rt.model.layers)
    assert float(m_block["loss"]) == float(m_none["loss"])
    for k, v in p_none.items():
        np.testing.assert_array_max_ulp(p_block[k].detach().numpy(),
                                        v.detach().numpy(), maxulp=1)
    b, s = c.batch["tokens"].shape
    assert rep.total() == float(m_none["ad_ops"]) == \
        7 * b * s * _conversions(tcfg)


def test_checkpoints_cross_the_packages(tmp_path):
    """The mamba tree (``params/periods/layer_i/mamba/...``: ``a_log``,
    ``d``, ``dt_bias``, the conv weights) and the MoE experts, both ways
    (``tests/test_torch_train_rwkv6_whisper.py``'s round trip)."""
    assert_checkpoint_round_trip(*_warm_case(JAMBA, "exact", *EXACT),
                                 tmp_path)


def test_train_cli_runs_jamba(tmp_path, capsys):
    """The CLI trains, checkpoints and resumes jamba
    (``tests/test_torch_train_rwkv6_whisper.py``'s run)."""
    run_cli_with_resume(JAMBA, tmp_path, capsys)

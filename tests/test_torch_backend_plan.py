"""Parity of the port's PIM backends, weight-stationary plan and QuantState
with the reference (``repro.pim.backend``, ``repro.pim.plan``,
``repro.core.quant_state``).

Within the port, every backend's prepared path equals its dynamic call
bit for bit (y and ad_ops).  Against the reference, outputs agree at
rtol=atol=1e-5 in f32 (different summation orders) and A/D-op counts are
equal.  A QuantState written by the reference's ``save_quant_state``
loads in the port and resolves the same registers for every layer name.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import quant_state as jqs  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.pim import backend as jbackend  # noqa: E402
from repro.pim import plan as jplan  # noqa: E402
from repro_torch.core import quant_state as tqs  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.models.registry import init as tinit  # noqa: E402
from repro_torch.pim import backend as tbackend  # noqa: E402
from repro_torch.pim import plan as tplan  # noqa: E402

BACKENDS = ["exact", "fake_quant", "pallas"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(31)


def _xw(rng, m=8, k=320, n=24):
    return (rng.normal(0, 1, (2, m // 2, k)).astype(np.float32),
            rng.normal(0, 0.1, (k, n)).astype(np.float32))


def _trq(mod, **kw):
    base = dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True)
    base.update(kw)
    return (jmake if mod == "jax" else tmake)(**base)


@pytest.mark.parametrize("auto_range", [False, True], ids=["fixed", "auto"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_dynamic_and_prepared_match_reference(rng, backend, auto_range):
    x, w = _xw(rng)
    kw = dict(auto_range=auto_range, delta_grid=1.0)
    # fixed registers on the default grid saturate; a finer step does not
    tk = {} if auto_range else dict(delta_r1=0.05)
    yj, oj = jbackend.pim_mvm(jnp.asarray(x), jnp.asarray(w),
                              _trq("jax", **tk), backend, **kw)
    yt, ot = tbackend.pim_mvm(torch.from_numpy(x), torch.from_numpy(w),
                              _trq("torch", **tk), backend, **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert float(ot) == float(oj)

    lp = tplan.prepare_linear(torch.from_numpy(w), _trq("torch", **tk),
                              backend=backend, auto_range=auto_range)
    yp, op = tbackend.pim_mvm(torch.from_numpy(x), plan=lp)
    assert torch.equal(yp, yt) and torch.equal(op, ot)

    lpj = jplan.prepare_linear(jnp.asarray(w), _trq("jax", **tk),
                               backend=backend, auto_range=auto_range)
    ypj, opj = jbackend.pim_mvm(jnp.asarray(x), plan=lpj)
    np.testing.assert_allclose(yp.numpy(), np.asarray(ypj), **TOL)
    assert float(op) == float(opj)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_bf16_compute_prepared_bitwise_and_close_to_reference(rng, backend):
    """bf16 activations and weights (the serving dtype): the prepared path
    equals the dynamic one bitwise; the reference agrees to bf16 output
    rounding."""
    x, w = _xw(rng)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    yt, ot = tbackend.pim_mvm(xt, wt, _trq("torch"), backend,
                              auto_range=True)
    lp = tplan.prepare_linear(wt, _trq("torch"), backend=backend,
                              auto_range=True, dtype=torch.bfloat16)
    yp, op = tbackend.pim_mvm(xt, plan=lp)
    assert yt.dtype == torch.bfloat16
    assert torch.equal(yp, yt) and torch.equal(op, ot)
    yj, oj = jbackend.pim_mvm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), _trq("jax"),
                              backend, auto_range=True)
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), rtol=1e-2,
                               atol=1e-2)
    assert float(ot) == float(oj)


def test_pallas_plan_holds_the_compute_dtype_image(rng):
    """The kernel streams the compute-dtype weights (widening bf16 in
    registers) and fits the auto-range register from its own partial sums,
    so the pallas plan holds the weight itself: the same storage as the
    bf16 tensor, no f32 image, no grouped copy."""
    w = torch.from_numpy(rng.normal(0, 1, (256, 128)).astype(
        np.float32)).to(torch.bfloat16)
    for auto in (True, False):
        lp = tplan.prepare_linear(w, _trq("torch"), backend="pallas",
                                  auto_range=auto, dtype=torch.bfloat16)
        assert lp.w is w and lp.w_g is None
    assert not hasattr(lp, "w_f32")
    ragged = tplan.prepare_linear(w[:200], _trq("torch"), backend="pallas",
                                  auto_range=True, dtype=torch.bfloat16)
    assert ragged.w.shape == (200, 128)              # the kernel masks K
    assert ragged.w.data_ptr() == w.data_ptr()
    f32 = tplan.prepare_linear(w, _trq("torch"), backend="pallas",
                               auto_range=True, dtype=torch.float32)
    assert f32.w.dtype == torch.float32 and torch.equal(f32.w, w.float())


def test_model_plan_names_and_stale_guard():
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="pallas", dtype="float32")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(tinit(cfg, seed=0, device="cpu"), assign=True)
    plan = tplan.prepare_params(model, cfg)
    assert len(plan) == 7 * cfg.n_layers
    assert plan.get("layers.1.mlp.w_down").n == cfg.d_model
    assert tplan.check_plan(plan, model) is plan
    small = get_config("llama3.2-3b", smoke=True).replace(d_ff=128)
    with pytest.raises(ValueError, match="stale plan"):
        tplan.check_plan(plan, build_model(small))


def test_backend_registry_errors():
    with pytest.raises(KeyError, match="registered"):
        with tbackend.use_backend("palas"):
            pass
    assert set(BACKENDS) <= set(tbackend.list_backends())
    w = torch.zeros(128, 8)
    lp = tplan.prepare_linear(w, _trq("torch"), backend="pallas")
    with pytest.raises(ValueError, match="w=None"):
        tbackend.pim_mvm(torch.zeros(1, 128), w, plan=lp)
    with pytest.raises(ValueError, match="programmed for backend"):
        tbackend.pim_mvm(torch.zeros(1, 128), plan=lp, backend="exact")
    with pytest.raises(ValueError, match="stale plan"):
        tbackend.pim_mvm(torch.zeros(1, 64), plan=lp)


def _reference_state():
    return jqs.QuantState(
        rules=(("layer_0/attn/w[qk]", jmake(delta_r1=0.25, bias=1.0, n_r1=3,
                                            n_r2=5, m=2, signed=True)),
               ("mlp/w_down$", jmake(delta_r1=0.5, n_r1=4, n_r2=4, m=3,
                                     mode="uniform", signed=True))),
        default=jmake(delta_r1=2.0, n_r1=6, n_r2=6, m=4, signed=True))


def test_quant_state_written_by_reference_resolves_the_same(tmp_path):
    qs_j = _reference_state()
    path = jqs.save_quant_state(str(tmp_path), qs_j)
    qs_t = tqs.load_quant_state(str(tmp_path))
    assert tplan.quant_state_token(qs_t) == jplan.quant_state_token(qs_j)
    fields = ("n_r1", "n_r2", "m", "nu", "mode", "signed")
    for name in ("layer_0/attn/wq", "layer_0/attn/wk", "layer_0/attn/wv",
                 "layer_1/attn/wq", "layer_0/mlp/w_down", "lm_head"):
        pj, pt = qs_j.lookup(name), qs_t.lookup(name)
        assert float(pt.delta_r1) == float(pj.delta_r1)
        assert float(pt.bias) == float(pj.bias)
        assert all(getattr(pt, f) == getattr(pj, f) for f in fields)
    # and the port writes what the reference reads
    back = jqs.load_quant_state(tqs.save_quant_state(
        str(tmp_path / "port.json"), qs_t))
    assert jplan.quant_state_token(back) == jplan.quant_state_token(qs_j)
    assert json.load(open(path))["version"] == tqs.QUANT_STATE_VERSION


def test_quant_state_corrupt_or_newer_file_raises(tmp_path):
    bad = tmp_path / "quant_state.json"
    bad.write_text('{"version": 1, "rules": [')
    with pytest.raises(ValueError, match="not valid JSON"):
        tqs.load_quant_state(str(tmp_path))
    bad.write_text(json.dumps({"version": 2, "rules": []}))
    with pytest.raises(ValueError, match="version 2"):
        tqs.load_quant_state(str(bad))


def test_quant_state_lands_in_plan_and_disables_auto_range():
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="pallas", dtype="float32")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(tinit(cfg, seed=0, device="cpu"), assign=True)
    qs = tqs.QuantState(rules=(("attn/wq", tmake(delta_r1=0.125, n_r1=3,
                                                 n_r2=5, m=2,
                                                 signed=True)),))
    plan = tplan.prepare_params(model, cfg, quant_state=qs)
    for depth in range(cfg.n_layers):
        lp = plan.get(f"layers.{depth}.attn.wq")
        assert not lp.auto_range and float(lp.trq.delta_r1) == 0.125
        assert plan.get(f"layers.{depth}.attn.wk").auto_range
    assert plan.qs_token == tplan.quant_state_token(qs)

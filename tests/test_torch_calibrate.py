"""Parity of the port's Algorithm 1 (``repro_torch.core.calibrate``), its
distribution judgement and energy accounting with the reference
(``repro.core.calibrate``/``distribution``/``energy``).

The same bit-line samples go to both: the quickstart's skewed distribution
(``examples/quickstart.py``) and ``collect_bl_samples`` of small layers.
The port scores all of a layer's candidates in one call of the
``trq_quant`` kernel's scoring entry (its plain version on the CPU); the
search must pick identical registers — the same mode, widths, bias, nu and
f32 step — and the same mean op count.  MSE values may differ in the last
bits (the port sums in f64, the reference in f32), so they are compared at
rtol=1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import distribution as jdist  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.pim.crossbar import collect_bl_samples as jcollect  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import distribution as tdist  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core.quant_state import (  # noqa: E402
    quant_state_from_calibration)
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.pim.crossbar import collect_bl_samples  # noqa: E402


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(53)


def _skewed(seed=0, n=100_000):
    """The quickstart's Fig-3a-style bit-line samples."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.normal(0, 2.5, n))
    tail = rng.random(n) < 0.04
    y[tail] += rng.uniform(20, 120, tail.sum())
    return np.round(y)


def _layer_samples(rng, m, k, n, lo=0):
    a = rng.integers(lo, 256, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    y_t = collect_bl_samples(torch.from_numpy(a), torch.from_numpy(w))
    y_j = np.asarray(jcollect(jnp.asarray(a), jnp.asarray(w)))
    np.testing.assert_array_equal(y_t.numpy(), y_j)
    return y_t, y_j


def _key(c):
    p = c.params
    return (c.chosen, p.mode, p.n_r1, p.n_r2, p.m, p.nu,
            np.float32(p.delta_r1).item(), np.float32(p.bias).item(),
            c.mean_ops, c.uniform_ops, c.dist.kind)


def _same(got, want):
    assert _key(got) == _key(want)
    np.testing.assert_allclose([got.mse, got.uniform_mse],
                               [want.mse, want.uniform_mse], rtol=1e-5)


def test_classify_matches_reference(rng):
    ys = [_skewed(), rng.normal(60, 3, 5000).round(), rng.uniform(0, 128,
                                                                  5000)]
    for y in ys:
        assert dataclasses.astuple(tdist.classify(y)) == \
            dataclasses.astuple(jdist.classify(y))
    assert tdist.r_ideal_bits(0, 128) == jdist.r_ideal_bits(0, 128) == 8


@pytest.mark.parametrize("n_max", [7, 5, 3])
def test_calibrate_layer_on_skewed_samples(n_max):
    y = _skewed()
    _same(tcal.calibrate_layer(torch.from_numpy(y), n_max=n_max),
          jcal.calibrate_layer(y, n_max=n_max))


@pytest.mark.parametrize("lo", [0, 200], ids=["uniform-a", "high-a"])
def test_calibrate_layer_on_bit_line_samples(rng, lo):
    y_t, y_j = _layer_samples(rng, 16, 300, 24, lo=lo)
    _same(tcal.calibrate_layer(y_t, n_max=7),
          jcal.calibrate_layer(y_j, n_max=7))


def test_subsample_draws_the_reference_indices(rng):
    y = rng.normal(0, 1, (3, 70_000)).astype(np.float32)
    got = tcal._subsample(torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcal._subsample(y)))
    small = np.arange(10, dtype=np.float32)
    assert torch.equal(tcal._subsample(small), torch.from_numpy(small))


def test_calibrate_model_and_quant_state(rng):
    y_t, y_j = _layer_samples(rng, 8, 256, 16)
    names = ["layer_0/attn/wq", "layer_1/mlp/w_down"]
    skew = _skewed(seed=1, n=20_000)
    cal_t = tcal.calibrate_model({names[0]: y_t, names[1]: skew})
    cal_j = jcal.calibrate_model({names[0]: y_j, names[1]: skew})
    for name in names:
        _same(cal_t[name], cal_j[name])
    s_t, s_j = tcal.summarize(cal_t), jcal.summarize(cal_j)
    assert s_t["layers"] == s_j["layers"] == 2
    assert s_t["twin_layers"] == s_j["twin_layers"]
    assert s_t["mean_ops"] == pytest.approx(s_j["mean_ops"])
    qs = tcal.to_quant_state(cal_t)
    assert qs.lookup(names[1]) is cal_t[names[1]].params
    assert qs.lookup("layer_11/mlp/w_down") is None
    assert tcal.to_quant_state(cal_t, signed=True).lookup(names[0]).signed
    direct = quant_state_from_calibration({"a.*": cal_t[names[0]].params},
                                          exact_names=False)
    assert direct.lookup("abc") is cal_t[names[0]].params


def test_calibrate_model_with_eval_fn_steps_n_max_down():
    y = _skewed(seed=2, n=20_000)
    seen = []

    def eval_fn(regs):
        seen.append(max(p.n_r2 for p in regs.values()))
        return 1.0 - 0.004 * len(seen)

    got = tcal.calibrate_model({"l": y}, eval_fn)
    seen_t, seen[:] = list(seen), []
    want = jcal.calibrate_model({"l": y}, eval_fn)
    assert seen_t == seen
    _same(got["l"], want["l"])


def test_energy_accounting_matches_reference(rng):
    assert tenergy.conversions_per_mvm(3072, 8192) == \
        jenergy.conversions_per_mvm(3072, 8192) == 64 * 24 * 8192
    assert tenergy.ideal_resolution() == jenergy.ideal_resolution() == 8
    assert tenergy.ideal_resolution(r_da=2) == jenergy.ideal_resolution(
        r_da=2)
    y = _skewed(n=4096).astype(np.float32)
    kw = dict(delta_r1=1.0, n_r1=3, n_r2=6, m=2)
    got = float(tenergy.trq_op_ratio(torch.from_numpy(y), tmake(**kw)))
    want = float(jenergy.trq_op_ratio(jnp.asarray(y), jmake(**kw)))
    assert got == want
    assert float(tenergy.mean_ops_trq(torch.from_numpy(y), tmake(**kw))) \
        == float(jenergy.mean_ops_trq(jnp.asarray(y), jmake(**kw)))
    assert tenergy.mean_ops_uniform() == jenergy.mean_ops_uniform() == 8.0


def _count_scoring(monkeypatch):
    """Count the calls of the scoring entry's CPU route."""
    from repro_torch.kernels.trq_quant import ops as k2_ops
    calls = []
    ref = k2_ops.trq_score_ref

    def counted(*a):
        calls.append(a[1].shape[0])
        return ref(*a)
    monkeypatch.setattr(k2_ops, "trq_score_ref", counted)
    return calls


@pytest.mark.parametrize("case", ["skewed", "uniform-a", "high-a"])
def test_calibrate_layer_scores_in_one_call(monkeypatch, case):
    """One scoring call per layer, over every candidate the search reads
    (the uniform fallbacks and the TRQ registers), and still the
    reference's pick."""
    if case == "skewed":
        y_t = y_j = _skewed(seed=3)
    else:
        rng = np.random.default_rng(54)
        y_t, y_j = _layer_samples(rng, 16, 300, 24,
                                  lo=0 if case == "uniform-a" else 200)
    calls = _count_scoring(monkeypatch)
    got = tcal.calibrate_layer(
        torch.from_numpy(y_t) if case == "skewed" else y_t, n_max=7)
    n_r2, uniform, twin = tcal.layer_candidates(got.dist, n_max=7)
    assert calls == [len(uniform) + len(twin)]
    _same(got, jcal.calibrate_layer(y_j, n_max=7))
    calls.clear()
    tcal.calibrate_model({"a": y_t, "b": _skewed(seed=4, n=20_000)})
    assert len(calls) == 2


def test_equal_scores_first_candidate_wins(monkeypatch):
    """Equal scores on every candidate: the first in the reference's order
    wins, among the uniform fallbacks and among the TRQ registers."""
    y = _skewed(seed=5, n=65536)
    n = len(y)

    def tied(y_, fregs, iregs):                   # mean ops 1.0, mse 0.0
        c = fregs.shape[0]
        return (torch.zeros(c, dtype=torch.float64),
                torch.full((c,), n, dtype=torch.int64))
    monkeypatch.setattr(tcal, "trq_score", tied)
    monkeypatch.setattr(jcal, "quant_mse", lambda y_, p: 0.0)
    monkeypatch.setattr(jcal, "_score", lambda y_, p: (0.0, 1.0))
    got = tcal.calibrate_layer(torch.from_numpy(y), n_max=7)
    want = jcal.calibrate_layer(y, n_max=7)
    _, uniform, twin = tcal.layer_candidates(got.dist, n_max=7)
    first = dataclasses.replace(got, params=twin[0])
    assert got.chosen == "twin" and _key(got) == _key(first)
    assert _key(got) == _key(want)
    tie = [(0.0, float(uniform[0].n_r2))] * len(uniform)
    assert tcal._best_uniform(uniform, tie) == (uniform[0], 0.0)
    assert got.mse == got.uniform_mse == 0.0 and got.mean_ops == 1.0

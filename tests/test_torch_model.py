"""Parity of the PyTorch port's dense LM and Runtime with the JAX reference.

The reference's llama3.2-3b smoke weights go through ``convert.from_jax``;
the same numpy tokens go through ``repro.runtime`` (JAX, CPU; ``pallas`` in
interpret mode) and ``repro_torch.runtime`` (``device="cpu"``: the kernels'
plain versions).  Compute is f32 on both sides (bf16 ``fake_quant`` does
not run on JAX's CPU backend).  Tolerances: rtol=atol=1e-4 on ``exact``
(summation order only), 1e-3 on ``fake_quant``/``pallas`` (a rare
quantizer boundary flip from a different f32 summation order moves one
element by one coarse step); A/D-op counts must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.pim.plan import iter_linears  # noqa: E402

ARCH = "llama3.2-3b"
TOL = {"exact": 1e-4, "fake_quant": 1e-3, "pallas": 1e-3}


@pytest.fixture
def rng():
    """A fresh stream per test: each test's tokens are fixed whatever runs
    before it (a different f32 summation order can flip one quantizer
    boundary, so the bars below hold for these inputs, not for any)."""
    return np.random.default_rng(1235)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(remat="none",
                                                dtype="float32")
    init_fn, _, _ = jbuild(cfg)
    params = init_fn(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(jax_params, backend, **kw):
    params, params_np = jax_params
    jcfg = jget_config(ARCH, smoke=True).replace(
        remat="none", dtype="float32", pim_backend=backend, **kw)
    tcfg = get_config(ARCH, smoke=True).replace(
        remat="none", dtype="float32", pim_backend=backend, **kw)
    rj = jrt.compile(jcfg, params)
    rt = trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu")
    return rj, rt


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", ["exact", "fake_quant", "pallas"])
def test_serve_entry_points_match_reference(jax_params, rng, backend):
    rj, rt = _pair(jax_params, backend)
    cfg = rt.cfg
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tol = TOL[backend]

    (lj, cj), repj = rj.prefill(toks[:, :8], max_len=16)
    (lt, ct), rept = rt.prefill(toks[:, :8], max_len=16)
    _close(lt, lj, tol)
    assert rept.total() == float(repj.ad_ops)

    pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32), (2, 8))
    (lj2, _), repj2 = rj.prefill_cont(toks[:, 8:], pos, cj)
    (lt2, _), rept2 = rt.prefill_cont(toks[:, 8:], pos, ct)
    _close(lt2, lj2, tol)
    assert rept2.total() == float(repj2.ad_ops)

    nxt = toks[:, :1]
    (lj3, _), repj3 = rj.decode(nxt, cj)
    (lt3, _), rept3 = rt.decode(nxt, ct)
    _close(lt3, lj3, tol)
    assert rept3.total() == float(repj3.ad_ops)


def test_known_op_counts_at_f32(jax_params, rng):
    """The counts the reference records at f32: 93,184 A/D ops for an
    8-token prefill and 11,648 for a one-row decode."""
    _, rt = _pair(jax_params, "pallas")
    toks = rng.integers(0, rt.cfg.vocab_size, (1, 8)).astype(np.int32)
    (_, cache), rep = rt.prefill(toks, max_len=16)
    assert rep.total() == 93184.0
    (_, _), rep = rt.decode(toks[:, :1], cache)
    assert rep.total() == 11648.0


def test_train_mode_logits_match_reference(jax_params, rng):
    rj, rt = _pair(jax_params, "exact")
    toks = rng.integers(0, rt.cfg.vocab_size, (2, 12)).astype(np.int32)
    (lj, _, _), _ = rj.apply({"tokens": toks})
    (lt, _, _), _ = rt.apply({"tokens": toks})
    assert lt.shape == (2, 12, rt.cfg.vocab_size)
    _close(lt, lj, TOL["exact"])


def test_unrolled_names_match_reference(jax_params, rng):
    """``scan_layers=False`` names every depth (``layer_1/...``); the
    plan's registers must then resolve per depth like the reference's."""
    rj, rt = _pair(jax_params, "pallas", scan_layers=False)
    names = [lin.name for _, lin in iter_linears(rt.model)]
    assert "layer_1/mlp/w_down" in names
    toks = rng.integers(0, rt.cfg.vocab_size, (1, 8)).astype(np.int32)
    (lj, _), repj = rj.prefill(toks, max_len=8)
    (lt, _), rept = rt.prefill(toks, max_len=8)
    _close(lt, lj, TOL["pallas"])
    assert rept.total() == float(repj.ad_ops)

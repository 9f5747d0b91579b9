"""Parity of the port's bit-exact audit path with the reference: the
crossbar functions (``repro.pim.crossbar``), the ``bit_exact`` backend and
its prepared path (``repro.pim.backend``/``plan``), the llama3.2-3b smoke
model and the serving engine.

On the CPU every ``xbar_mvm`` call runs the kernel's plain version.  The
bit-line sums are exact integers and, at these sizes, every shift-add
stays below 2^24, so functions and backend match at ``atol=0`` with op
counts equal.  Model logits compare at 1e-3 in f32 (attention and norms
round differently in the two frameworks, which may move one PTQ integer
by one step); tokens and per-request ``ad_ops`` must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim import backend as jbackend  # noqa: E402
from repro.pim import crossbar as jxb  # noqa: E402
from repro.pim import plan as jplan  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.pim import backend as tbackend  # noqa: E402
from repro_torch.pim import crossbar as txb  # noqa: E402
from repro_torch.pim import plan as tplan  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "llama3.2-3b"
REGS = [None, dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True),
        dict(delta_r1=1.0, n_r1=3, n_r2=5, m=4, bias=3.0, nu=2)]
REG_IDS = ["lossless", "default", "bias3"]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(47)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _regs(mod, regs):
    if regs is None:
        return None
    return (jmake if mod == "jax" else tmake)(**regs)


# ---------------------------------------------------------------------------
# crossbar functions
# ---------------------------------------------------------------------------

def test_offset_encode_and_bitplanes(rng):
    w = rng.integers(-128, 128, (64, 8)).astype(np.int32)
    u_j, zp_j = jxb.offset_encode(jnp.asarray(w), 8)
    u_t, zp_t = txb.offset_encode(_t(w), 8)
    assert zp_t == zp_j == 128 and u_t.dtype == torch.int32
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    x = rng.integers(0, 256, (16, 8)).astype(np.int32)
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            txb.bitplanes(_t(x), 8, axis=axis).numpy(),
            np.asarray(jxb.bitplanes(jnp.asarray(x), 8, axis=axis)))


@pytest.mark.parametrize("k", [256, 300])
def test_weight_planes_and_bl_samples(rng, k):
    a = rng.integers(0, 256, (4, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, 8)).astype(np.int32)
    wp_t = txb.weight_planes(_t(w))
    assert wp_t.dtype == torch.int8
    np.testing.assert_array_equal(wp_t.numpy(),
                                  np.asarray(jxb.weight_planes(
                                      jnp.asarray(w))))
    s_t = txb.collect_bl_samples(_t(a), _t(w))
    assert s_t.shape == (8, 8, 2 if k == 256 else 3, 4, 8)
    np.testing.assert_array_equal(
        s_t.numpy(),
        np.asarray(jxb.collect_bl_samples(jnp.asarray(a), jnp.asarray(w))))
    assert float(s_t.min()) >= 0.0 and float(s_t.max()) <= 128.0


@pytest.mark.parametrize("regs", REGS, ids=REG_IDS)
@pytest.mark.parametrize("m,k,n", [(4, 64, 8), (8, 128, 16), (3, 300, 5)])
def test_bit_exact_mvm_matches_reference(rng, m, k, n, regs):
    a = rng.integers(0, 256, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    y_j, o_j = jxb.bit_exact_mvm(jnp.asarray(a), jnp.asarray(w),
                                 _regs("jax", regs), with_ops=True)
    y_t, o_t = txb.bit_exact_mvm(_t(a), _t(w), _regs("torch", regs),
                                 with_ops=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=0)
    assert o_t.dtype == torch.int64 and int(o_t) == float(o_j)
    y_p, o_p = txb.bit_exact_mvm(_t(a), None, _regs("torch", regs),
                                 with_ops=True,
                                 u_planes=txb.weight_planes(_t(w)))
    assert torch.equal(y_p, y_t) and torch.equal(o_p, o_t)
    if regs is None:
        np.testing.assert_array_equal(y_t.numpy(),
                                      a.astype(np.int64) @ w.astype(np.int64))


# ---------------------------------------------------------------------------
# the bit_exact backend, dynamic and prepared
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regs", REGS, ids=REG_IDS)
def test_backend_dynamic_and_prepared_match_reference(rng, regs):
    x = rng.normal(0, 1, (2, 4, 320)).astype(np.float32)
    w = rng.normal(0, 0.1, (320, 24)).astype(np.float32)
    out_j = jbackend.pim_mvm(jnp.asarray(x), jnp.asarray(w),
                             _regs("jax", regs), "bit_exact")
    out_t = tbackend.pim_mvm(_t(x), _t(w), _regs("torch", regs), "bit_exact")
    np.testing.assert_allclose(out_t.y.numpy(), np.asarray(out_j.y), atol=0)
    assert float(out_t.ad_ops) == float(out_j.ad_ops)

    lp = tplan.prepare_linear(_t(w), _regs("torch", regs),
                              backend="bit_exact")
    assert lp.w_mask.shape == (8, 3, 24, 4) and lp.w_mask.dtype == \
        torch.int32
    out_p = tbackend.pim_mvm(_t(x), plan=lp)
    assert torch.equal(out_p.y, out_t.y)
    assert torch.equal(out_p.ad_ops, out_t.ad_ops)
    lpj = jplan.prepare_linear(jnp.asarray(w), _regs("jax", regs),
                               backend="bit_exact")
    out_pj = jbackend.pim_mvm(jnp.asarray(x), plan=lpj)
    np.testing.assert_allclose(out_p.y.numpy(), np.asarray(out_pj.y),
                               atol=0)
    np.testing.assert_array_equal(lp.w_colsum.numpy(),
                                  np.asarray(lpj.w_colsum))


def test_pinned_scales_match_reference(rng):
    x = rng.normal(0, 1, (5, 128)).astype(np.float32)
    w = rng.normal(0, 0.1, (128, 12)).astype(np.float32)
    kw = dict(a_scale=0.02, w_scale=0.003)
    out_j = jbackend.pim_mvm(jnp.asarray(x), jnp.asarray(w), None,
                             "bit_exact", **kw)
    out_t = tbackend.pim_mvm(_t(x), _t(w), None, "bit_exact", **kw)
    np.testing.assert_allclose(out_t.y.numpy(), np.asarray(out_j.y), atol=0)
    lp = tplan.prepare_linear(_t(w), None, backend="bit_exact")
    a_only = tbackend.pim_mvm(_t(x), plan=lp, a_scale=0.02)
    want = jbackend.pim_mvm(jnp.asarray(x), plan=jplan.prepare_linear(
        jnp.asarray(w), None, backend="bit_exact"), a_scale=0.02)
    np.testing.assert_allclose(a_only.y.numpy(), np.asarray(want.y), atol=0)


def test_prepared_rejects_a_per_call_w_scale(rng):
    w = torch.from_numpy(rng.normal(0, 0.1, (128, 8)).astype(np.float32))
    lp = tplan.prepare_linear(w, None, backend="bit_exact")
    with pytest.raises(ValueError, match="w_scale override"):
        tbackend.pim_mvm(torch.zeros(2, 128), plan=lp, w_scale=0.01)


def test_bf16_prepared_equals_dynamic(rng):
    """The serving dtype: the plan programs the weights cast to bf16, as
    the dynamic call sees them."""
    x = torch.from_numpy(rng.normal(0, 1, (6, 256)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.1, (256, 40)).astype(np.float32))
    p = tmake(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True)
    dyn = tbackend.pim_mvm(x, w.to(x.dtype), p, "bit_exact")
    lp = tplan.prepare_linear(w, p, backend="bit_exact", dtype=torch.bfloat16)
    prep = tbackend.pim_mvm(x, plan=lp)
    assert dyn.y.dtype == torch.bfloat16
    assert torch.equal(prep.y, dyn.y) and torch.equal(prep.ad_ops,
                                                      dyn.ad_ops)


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(remat="none",
                                                dtype="float32")
    params = jbuild(cfg)[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(jax_params, **kw):
    params, params_np = jax_params
    over = dict(remat="none", dtype="float32", pim_backend="bit_exact", **kw)
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    return (jrt.compile(jcfg, params),
            trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=1e-3, atol=1e-3)


def test_model_prefill_and_decode_match_reference(jax_params):
    rj, rt = _pair(jax_params)
    toks = np.random.default_rng(1235).integers(
        0, rt.cfg.vocab_size, (2, 9)).astype(np.int32)
    (lj, cj), repj = rj.prefill(toks[:, :8], max_len=16)
    (lt, ct), rept = rt.prefill(toks[:, :8], max_len=16)
    _close(lt, lj)
    # every conversion costs nu + n_r = 7 ops at the default registers
    want = 7 * 64 * 2 * 8 * rt.cfg.n_layers * 832
    assert rept.total() == float(repj.ad_ops) == want
    (lj2, _), repj2 = rj.decode(toks[:, 8:], cj)
    (lt2, _), rept2 = rt.decode(toks[:, 8:], ct)
    _close(lt2, lj2)
    assert rept2.total() == float(repj2.ad_ops)


def test_engine_tokens_and_ad_ops_match_reference(jax_params):
    rj, rt = _pair(jax_params)
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, rt.cfg.vocab_size, 24)
    prompts = [np.concatenate([prefix, rng.integers(0, rt.cfg.vocab_size,
                                                    8)]) for _ in range(3)]
    kw = dict(max_batch=2, max_len=64, block_size=16)
    jeng = JServeEngine(rj, **kw)
    ref = [jeng.submit(p, max_new_tokens=4) for p in prompts]
    jeng.run()
    eng = ServeEngine(rt, **kw)
    got = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == [r.prefill_ad_ops for r in ref]
    assert [r.reused_tokens for r in got] == [0, 16, 16]


def test_launch_serve_cli_offers_bit_exact(capsys):
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "2", "--pim",
                        "bit_exact", "--prompt-len", "8",
                        "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "pim=bit_exact" in out and "served 2 requests, 4 tokens" in out
    assert "crossbar layer plans (bit_exact)" in out

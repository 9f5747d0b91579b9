"""Parity of the port's rwkv6 (``repro_torch.models.rwkv6`` and the rwkv
path of ``models.lm``, ``models.registry`` and ``convert``) with the JAX
reference ``repro.models.rwkv6``.

The same seeded numpy inputs go through both packages.  The reference's
init leaves the Finch features at zero (``decay_lora_b = 0``,
``bonus_u = 0``), so every test here overwrites both with the same seeded
nonzero values on both sides, or it would test a constant decay.  Compute
is f32 (bf16 ``fake_quant`` does not run on JAX's CPU backend).  Bars: the
WKV and the time-mix at rtol=atol=1e-5 with A/D ops equal; whole models
give equal greedy tokens and A/D ops, and logits within 1e-4 on ``exact``
(summation order only) and 1e-3 on the quantized datapaths (a quantizer
boundary flip from another f32 summation order moves one element by one
step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim.backend import ad_ops_tally as jtally  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.layers import PimContext  # noqa: E402
from repro_torch.models.lm import LM, init_cache  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402

ARCH = "rwkv6-7b"
F32 = dict(remat="none", dtype="float32")
TOL = {"exact": 1e-4, "fake_quant": 1e-3, "pallas": 1e-3, "bit_exact": 1e-3}


@pytest.fixture
def rng():
    """A fresh stream per test: each test's inputs are fixed whatever runs
    before it."""
    return np.random.default_rng(617)


def _finch(params, rng):
    """Seeded nonzero decay LoRA B and bonus u in every rwkv layer of a
    reference parameter tree (period-stacked or one layer's)."""
    def visit(tree):
        if "decay_lora_b" in tree:
            for key, scale in (("decay_lora_b", 0.5), ("bonus_u", 0.5)):
                leaf = tree[key]
                tree[key] = jnp.asarray(
                    rng.standard_normal(leaf.shape) * scale, leaf.dtype)
            return tree
        return {k: visit(v) if isinstance(v, dict) else v
                for k, v in tree.items()}
    return visit(params)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the WKV
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, b, h, s, hs):
    r, k, v = (rng.standard_normal((b, h, s, hs)).astype(np.float32)
               for _ in range(3))
    # log-decays across decay_w's range, with the LoRA's spread
    base = np.linspace(-6.0, -1.0, h * hs, dtype=np.float32).reshape(h, hs)
    logw = -np.exp(base[None, :, None, :] + 0.5 * rng.standard_normal(
        (b, h, s, hs))).astype(np.float32)
    u = rng.standard_normal((h, hs)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("s", [16, 48, 37])
@pytest.mark.parametrize("warm", [False, True])
def test_wkv_matches_reference(rng, s, warm):
    """``wkv`` (chunked scan, right padding with log-decay 0) against the
    reference's ``wkv_scan`` over the same zero padding, from a zero and a
    nonzero carried state."""
    chunk = 16
    r, k, v, logw, u, s0 = _wkv_inputs(rng, 2, 2, s, 64)
    if not warm:
        s0 = np.zeros_like(s0)
    pad = (-s) % chunk
    zf = ((0, 0), (0, 0), (0, pad), (0, 0))
    want, want_s = jrwkv.wkv_scan(*(jnp.pad(t, zf) for t in (r, k, v, logw)),
                                  jnp.asarray(u), jnp.asarray(s0), chunk)
    got, got_s = rwkv6.wkv(*map(_t, (r, k, v, logw, u, s0)), chunk)
    assert got.shape == (2, 2, s, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_chunk_wkv_matches_reference(rng):
    r, k, v, logw, u, s0 = _wkv_inputs(rng, 1, 2, 16, 64)
    want, want_s = jrwkv._chunk_wkv(r, k, v, logw, u, s0)
    got, got_s = rwkv6.chunk_wkv(*map(_t, (r, k, v, logw, u, s0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_chunked_scan_equals_the_recurrence(rng):
    """The chunked scan and the per-token recurrence are one function:
    S tokens through ``wkv`` equal S ``wkv_step`` calls, outputs and the
    carried state, from zero and from a nonzero state.  The two take the
    decay products in other orders (log-space differences against repeated
    products over 37 f32 steps), hence 1e-4."""
    r, k, v, logw, u, s0 = map(_t, _wkv_inputs(rng, 2, 2, 37, 64))
    for start in (torch.zeros_like(s0), s0):
        out, s_end = rwkv6.wkv(r, k, v, logw, u, start, 16)
        st, steps = start, []
        for t in range(r.shape[2]):
            o, st = rwkv6.wkv_step(r[:, :, t], k[:, :, t], v[:, :, t],
                                   logw[:, :, t], u, st)
            steps.append(o)
        torch.testing.assert_close(out, torch.cat(steps, 2), rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(s_end, st, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the time-mix module
# ---------------------------------------------------------------------------

def _layer_pair(rng, backend):
    jcfg = jget_config(ARCH, smoke=True).replace(pim_backend=backend, **F32)
    tcfg = get_config(ARCH, smoke=True).replace(pim_backend=backend, **F32)
    p = _finch(jrwkv.init_rwkv(jax.random.PRNGKey(3), jcfg), rng)
    mod = rwkv6.RWKV6TimeMix(tcfg, "layer_0/rwkv", torch.float32,
                             device="meta")
    state = {path: _t(leaf) for path, leaf in _flatten(p)}
    mod.load_state_dict(state, assign=True)
    return jcfg, tcfg, p, mod


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_time_mix_matches_reference(rng, backend, mode):
    """Prefill (S = 21: a padded last chunk) and a single-token decode with
    a cache: outputs, the new ``s`` and ``x_prev``, and A/D ops."""
    jcfg, tcfg, p, mod = _layer_pair(rng, backend)
    s = 21 if mode == "prefill" else 1
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    cache = {"s": rng.standard_normal((2, 2, 64, 64)).astype(np.float32)
             * 0.1,
             "x_prev": rng.standard_normal((2, 1, jcfg.d_model)).astype(
                 np.float32)}
    with jtally() as tally:
        want, want_c = jrwkv.apply_rwkv(
            p, jnp.asarray(x), jcfg, prefix="layer_0/rwkv",
            cache={k: jnp.asarray(v) for k, v in cache.items()})
    ctx = PimContext(tcfg, backend, device="cpu")
    with torch.no_grad():
        got, got_c = mod(_t(x), ctx, cache={k: _t(v)
                                            for k, v in cache.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key in ("s", "x_prev"):
        np.testing.assert_allclose(got_c[key].numpy(),
                                   np.asarray(want_c[key]), rtol=1e-5,
                                   atol=1e-5)
    assert int(ctx.ops) == int(tally.total())
    assert backend == "exact" or int(ctx.ops) > 0


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(**F32)
    params = jbuild(cfg)[0](jax.random.PRNGKey(0))
    params = _finch(params, np.random.default_rng(11))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("backend", ["exact", "fake_quant", "pallas",
                                     "bit_exact"])
def test_model_greedy_tokens_and_ad_ops_match_reference(jax_params, rng,
                                                        backend):
    """Prefill of 12 tokens, then 3 greedy decode steps, batch 2: tokens
    and A/D ops equal each step, logits within the bar."""
    params, params_np = jax_params
    jcfg = jget_config(ARCH, smoke=True).replace(pim_backend=backend, **F32)
    tcfg = get_config(ARCH, smoke=True).replace(pim_backend=backend, **F32)
    rj = jrt.compile(jcfg, params)
    rt = trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu")
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    (lj, cj), repj = rj.prefill(toks, max_len=16)
    (lt, ct), rept = rt.prefill(toks, max_len=16)
    for step in range(4):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=TOL[backend], atol=TOL[backend])
        assert rept.total() == float(repj.ad_ops)
        nxt_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
        nxt_t = lt.argmax(-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(nxt_t, nxt_j)
        if step == 3:
            break
        (lj, cj), repj = rj.decode(nxt_j, cj)
        (lt, ct), rept = rt.decode(nxt_t, ct)
    for key in ("s", "x_prev"):
        np.testing.assert_allclose(
            ct[key].float().numpy(),
            np.asarray(cj["layer_0"][key], np.float32),
            rtol=TOL[backend], atol=TOL[backend])


def test_from_jax_keys_equal_the_model_state_dict(jax_params):
    cfg = get_config(ARCH, smoke=True).replace(**F32)
    state = from_jax(jax_params[1], cfg)
    assert set(state) == set(LM(cfg, device="meta").state_dict())
    assert "layers.1.rwkv.ln_x.bias" in state
    assert "lm_head.w" in state


def test_init_draws_the_reference_leaves():
    """The seeded init's rwkv leaves carry the reference's constants,
    shapes and dtypes (the random ones its scale)."""
    jcfg = jget_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = dict(_flatten(jrwkv.init_rwkv(jax.random.PRNGKey(0), jcfg)))
    got = init(cfg, seed=0, device="cpu")
    for path, want in ref.items():
        leaf = got[f"layers.0.rwkv.{path}"]
        assert tuple(leaf.shape) == want.shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path
        if path in ("mu", "decay_lora_b", "bonus_u", "ln_x.scale",
                    "ln_x.bias"):
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          want.astype(np.float32))
    # jnp.linspace rounds some points another way than torch's: one ulp
    np.testing.assert_allclose(got["layers.0.rwkv.decay_w"].numpy(),
                               ref["decay_w"], rtol=2.5e-7, atol=0)
    a = got["layers.0.rwkv.decay_lora_a"].float()
    assert abs(float(a.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_cache_size_does_not_depend_on_max_len():
    """O(1) recurrent state: the cache holds ``s`` and ``x_prev`` only, of
    the reference's shapes and dtypes, whatever ``max_len``."""
    cfg = get_config(ARCH, smoke=True)
    small, big = (init_cache(cfg, 1, n) for n in (128, 4096))
    assert sorted(small) == ["s", "x_prev"]
    assert sum(t.numel() for t in small.values()) == \
        sum(t.numel() for t in big.values())
    ref = jbuild(jget_config(ARCH, smoke=True))[2](1, 128)["layer_0"]
    for key in ("s", "x_prev"):
        assert tuple(small[key].shape) == ref[key].shape
        assert str(small[key].dtype).split(".")[-1] == str(ref[key].dtype)

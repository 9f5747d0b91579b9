"""Parity of the port's noise seam (``repro_torch.pim.noise``, the ``noisy``
backend, ``Runtime(crossbar_model=...)``, ``benchmarks/noise_sweep_torch.py``)
with ``repro.pim.noise``.

The reference draws with threefry ``fold_in``, the port with seeded
``torch.Generator`` streams, so the two agree where nothing is drawn —
the null and all-zeros models equal ``bit_exact`` bitwise, ``ir_drop`` (the
one deterministic field) matches exactly — and statistically where it is:
fault rates within a binomial bound of their parameters in both packages.
Within the port a seed reproduces bit for bit, on the dynamic path and in
a baked plan alike.
"""
import json
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim import noise as jnoise  # noqa: E402
from repro.pim.crossbar import PimConfig as JPimConfig  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.pim import (CrossbarModel, pim_mvm, prepare_linear,  # noqa: E402
                             prepare_params)
from repro_torch.pim import noise as tnoise  # noqa: E402
from repro_torch.pim.crossbar import PimConfig, weight_planes  # noqa: E402

ARCH = "llama3.2-3b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("g_sigma", "sa0", "sa1", "read_sigma", "ir_drop", "adc_offset",
          "adc_sigma")
REGS = [None, dict(delta_r1=1.0, n_r1=3, n_r2=5, m=4, bias=3.0, nu=2)]
REG_IDS = ["lossless", "bias3"]
ALL_FAULTS = dict(g_sigma=0.05, sa0=0.01, sa1=0.01, read_sigma=0.3,
                  ir_drop=0.1, adc_offset=0.2, adc_sigma=0.1, seed=3)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(91)


def _xw(rng, m=3, k=300, n=40):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return x, w


def _regs(mod, regs):
    if regs is None:
        return None
    return (jmake if mod == "jax" else tmake)(**regs)


def _zero_model(kind):
    return {"none": None, "zeros": CrossbarModel(),
            "zero_tensors": CrossbarModel(
                **{f: torch.zeros(()) for f in FIELDS})}[kind]


# ---------------------------------------------------------------------------
# zero is exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "zeros", "zero_tensors"])
@pytest.mark.parametrize("regs", REGS, ids=REG_IDS)
def test_null_and_zero_models_equal_bit_exact(rng, kind, regs):
    """No model and the all-zeros model take the bit_exact backend; zero
    fields given as tensors take the full analog datapath, which they
    perturb by exactly +0.0 / *1.0.  The reference's all-zeros model gives
    the same y and ops."""
    x, w = _xw(rng)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = pim_mvm(xt, wt, _regs("torch", regs), backend="bit_exact")
    got = pim_mvm(xt, wt, _regs("torch", regs), backend="noisy",
                  crossbar_model=_zero_model(kind))
    assert torch.equal(got.y, want.y)
    assert int(got.ad_ops) == int(want.ad_ops)
    ref = jnoise.noisy_backend(jnp.asarray(x), jnp.asarray(w),
                               _regs("jax", regs),
                               crossbar_model=jnoise.CrossbarModel())
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(ref.y))
    assert int(got.ad_ops) == float(ref.ad_ops)


def test_zero_models_equal_bit_exact_at_model_level():
    """The smoke model with the reference's weights (f32): logits and
    ad_ops of a prefill and a decode bitwise equal to bit_exact, on the
    prepared and the dynamic path; the reference's all-zeros model spends
    the same ops."""
    over = dict(remat="none", dtype="float32")
    jcfg = jget_config(ARCH, smoke=True).replace(pim_backend="noisy", **over)
    params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, smoke=True).replace(pim_backend="bit_exact",
                                                **over)
    state = from_jax(jax.tree.map(np.asarray, params), tcfg)
    toks = np.random.default_rng(1235).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    rt_be = trt.compile(tcfg, state, device="cpu")
    (l_be, c_be), r_be = rt_be.prefill(toks[:, :8], max_len=16)
    (d_be, _), rd_be = rt_be.decode(toks[:, 8:], c_be)
    for kind in ("zeros", "zero_tensors"):
        for plan in (True, False):
            rt = rt_be.with_overrides(backend="noisy", plan=plan,
                                      crossbar_model=_zero_model(kind))
            (lg, c), r = rt.prefill(toks[:, :8], max_len=16)
            (dg, _), rd = rt.decode(toks[:, 8:], c)
            assert torch.equal(lg, l_be) and torch.equal(dg, d_be)
            assert r.total() == r_be.total() and rd.total() == rd_be.total()
    rj = jrt.compile(jcfg, params, crossbar_model=jnoise.CrossbarModel())
    (_, _), rep = rj.prefill(jnp.asarray(toks[:, :8]), max_len=16)
    assert float(rep.ad_ops) == r_be.total()


# ---------------------------------------------------------------------------
# the deterministic field
# ---------------------------------------------------------------------------

def test_ir_drop_matches_reference_exactly(rng):
    p = rng.integers(0, 129, (8, 8, 2, 3, 5)).astype(np.float32)
    got = tnoise.perturb_psums(torch.from_numpy(p),
                               CrossbarModel(ir_drop=0.07), PimConfig())
    want = jnoise.perturb_psums(jnp.asarray(p),
                                jnoise.CrossbarModel(ir_drop=0.07),
                                JPimConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), p)


@pytest.mark.parametrize("regs", REGS, ids=REG_IDS)
def test_ir_drop_backend_matches_reference_exactly(rng, regs):
    x, w = _xw(rng, m=4, k=256, n=24)
    got = pim_mvm(torch.from_numpy(x), torch.from_numpy(w),
                  _regs("torch", regs), backend="noisy",
                  crossbar_model=CrossbarModel(ir_drop=0.05))
    want = jnoise.noisy_backend(
        jnp.asarray(x), jnp.asarray(w), _regs("jax", regs),
        crossbar_model=jnoise.CrossbarModel(ir_drop=0.05))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    assert int(got.ad_ops) == float(want.ad_ops)


# ---------------------------------------------------------------------------
# seeded draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regs", REGS, ids=REG_IDS)
def test_seeded_model_reproduces_on_both_paths(rng, regs):
    x, w = _xw(rng)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p = _regs("torch", regs)
    model = CrossbarModel(**ALL_FAULTS)
    a = pim_mvm(xt, wt, p, backend="noisy", crossbar_model=model)
    b = pim_mvm(xt, wt, p, backend="noisy", crossbar_model=model)
    lp = prepare_linear(wt, p, backend="noisy", crossbar_model=model)
    c = pim_mvm(xt, plan=lp, crossbar_model=model)
    for o in (b, c):
        assert torch.equal(o.y, a.y) and int(o.ad_ops) == int(a.ad_ops)
    assert lp.w_analog is not None and lp.adc_off is not None
    ideal = pim_mvm(xt, wt, p, backend="bit_exact")
    assert torch.isfinite(a.y).all() and not torch.equal(a.y, ideal.y)
    # another fault seed is another device; another key another read
    for other in (model.replace(seed=4), model.replace(key=9)):
        o = pim_mvm(xt, wt, p, backend="noisy", crossbar_model=other)
        assert not torch.equal(o.y, a.y)
    # call-side noise on a device-null plan: the packed cells, unpacked
    read = CrossbarModel(read_sigma=0.3, key=2)
    lp0 = prepare_linear(wt, p, backend="noisy")
    assert lp0.w_analog is None and lp0.w_mask is not None
    assert torch.equal(pim_mvm(xt, plan=lp0, crossbar_model=read).y,
                       pim_mvm(xt, wt, p, backend="noisy",
                               crossbar_model=read).y)


def test_seeded_model_reproduces_at_model_level():
    cfg = get_config(ARCH, smoke=True).replace(remat="none",
                                               pim_backend="noisy")
    state = init(cfg, seed=0, device="cpu")
    model = CrossbarModel(**ALL_FAULTS)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 8))
    outs = []
    for plan in (True, True, None):
        rt = trt.compile(cfg, state, device="cpu", plan=plan,
                         crossbar_model=model)
        (lg, _), rep = rt.prefill(toks, max_len=16)
        outs.append((lg, rep.total()))
    assert all(torch.equal(lg, outs[0][0]) and ops == outs[0][1]
               for lg, ops in outs[1:])


def _drawn(planes, analog):
    ones = planes == 1
    g1 = analog[ones]
    moved = g1[(g1 != 0) & (g1 != 1)]
    return dict(sa0=(float((g1 == 0).mean()), int(ones.sum())),
                sa1=(float((analog[~ones] == 1).mean()), int((~ones).sum())),
                g_sigma=(float(np.std(moved.astype(np.float64) - 1,
                                      ddof=1)), moved.size))


def test_fault_rates_within_a_binomial_bound_in_both_packages(rng):
    """SA0/SA1 rates within 5 binomial standard errors of the model's
    parameters and the drawn sigmas within 5 standard errors (relative
    1/sqrt(2n)), in the port and in the reference alike."""
    w_int = rng.integers(-128, 128, (1024, 256)).astype(np.int32)
    params = dict(g_sigma=0.1, sa0=0.02, sa1=0.01, adc_offset=0.2,
                  read_sigma=0.3, seed=5)
    cfg = PimConfig()
    planes_t = weight_planes(torch.from_numpy(w_int), cfg)
    planes = planes_t.numpy()
    tm = CrossbarModel(**params)
    salt = tnoise.value_salt(torch.from_numpy(w_int))
    port = _drawn(planes, tnoise.perturb_planes(planes_t, tm, salt).numpy())
    off = tnoise.adc_offsets(tm, salt, (8, 8, 256), "cpu").numpy()
    port["adc_offset"] = (float(off.std(ddof=1)), off.size)
    p = tnoise.perturb_psums(torch.zeros((8, 8, 8, 4, 256)),
                             tm.replace(ir_drop=0.0, adc_sigma=0.0), cfg)
    port["read_sigma"] = (float(p.numpy().std(ddof=1)), p.numel())
    jm = jnoise.CrossbarModel(**params)
    ref = _drawn(planes, np.asarray(jnoise.perturb_planes(
        jnp.asarray(planes), jm, jnp.uint32(7))))
    for drawn in (port, ref):
        for field, (got, n) in drawn.items():
            want = params[field]
            se = math.sqrt(want * (1 - want) / n) if field.startswith("sa") \
                else want / math.sqrt(2 * n)
            assert abs(got - want) <= 5 * se, (field, got, want, n)
    assert len(port) == 5 and len(ref) == 3


def test_value_salt_is_content_addressed():
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert tnoise.value_salt(a) == tnoise.value_salt(a.clone())
    assert tnoise.value_salt(a) != tnoise.value_salt(a.flip(0))
    assert 0 <= tnoise.value_salt(a) < 2 ** 32


# ---------------------------------------------------------------------------
# Runtime: the eager rejection and the device fingerprint
# ---------------------------------------------------------------------------

def test_non_null_model_on_a_noise_blind_backend_raises():
    cfg = get_config(ARCH, smoke=True).replace(remat="none",
                                               pim_backend="pallas")
    state = init(cfg, seed=0, device="cpu")
    faulty = CrossbarModel(sa0=0.01)
    with pytest.raises(ValueError, match="not noise-aware"):
        trt.compile(cfg, state, device="cpu", crossbar_model=faulty)
    rt = trt.compile(cfg, state, device="cpu",
                     crossbar_model=CrossbarModel())
    with pytest.raises(ValueError, match="not noise-aware"):
        rt.with_overrides(crossbar_model=faulty)
    with tnoise.use_crossbar_model(faulty):
        with pytest.raises(ValueError, match="not noise-aware"):
            trt.compile(cfg, state, device="cpu")
    assert rt.with_overrides(backend="noisy",
                             crossbar_model=faulty).backend == "noisy"
    # the reference rejects the same combination
    jcfg = jget_config(ARCH, smoke=True).replace(remat="none",
                                                 pim_backend="pallas")
    params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="not noise-aware"):
        jrt.compile(jcfg, params, crossbar_model=jnoise.CrossbarModel(
            sa0=0.01))


def test_plan_is_tied_to_its_device():
    cfg = get_config(ARCH, smoke=True).replace(remat="none",
                                               pim_backend="noisy")
    state = init(cfg, seed=0, device="cpu")
    dev = CrossbarModel(sa0=0.01, seed=1)
    assert CrossbarModel(read_sigma=0.2).plan_token() is None
    assert dev.plan_token() == tnoise.crossbar_token(dev.replace(
        read_sigma=0.5)) != dev.replace(seed=2).plan_token()
    # the same fingerprint as the reference's for the same device
    assert dev.plan_token() == jnoise.CrossbarModel(
        sa0=0.01, seed=1).plan_token()
    rt = trt.compile(cfg, state, device="cpu", crossbar_model=dev)
    assert rt.plan.cm_token == dev.plan_token()
    with pytest.raises(ValueError, match="different CrossbarModel"):
        trt.compile(cfg, state, device="cpu", plan=rt.plan,
                    crossbar_model=dev.replace(seed=2))
    # call-side noise keeps the baked plan; another device re-programs it
    assert rt.with_overrides(crossbar_model=dev.replace(
        read_sigma=0.1)).plan is rt.plan
    assert rt.with_overrides(crossbar_model=dev.replace(
        seed=2)).plan is not rt.plan
    plan = prepare_params(rt.model, cfg, backend="noisy",
                          crossbar_model=dev)
    assert plan.cm_token == rt.plan.cm_token and len(plan) == 14


def test_launch_serve_offers_noisy(capsys):
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "2", "--pim",
                        "noisy", "--prompt-len", "8",
                        "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "crossbar layer plans (noisy)" in out
    assert "served 2 requests, 4 tokens" in out


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def test_noise_sweep_quick_passes_the_committed_gates():
    """``noise_sweep_torch --quick`` with the reference's tiny-model weights:
    the identity records are exactly 1.0, and every record the
    reference's sweep committed to ``BENCH_kernels.json`` passes
    ``check_regression`` (identities exactly, divergences and agreement
    as counts within 25 %); its CPU timings are not compared."""
    import importlib
    ns = importlib.import_module("benchmarks.noise_sweep_torch")
    cr = importlib.import_module("benchmarks.check_regression")
    jns = importlib.import_module("benchmarks.noise_sweep")
    jcfg = jns._tiny(ARCH, "noisy")
    params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
    state = from_jax(jax.tree.map(np.asarray, params), ns.tiny_config())
    records = ns.run(quick=True, device="cpu", state=state)
    ident = records["noise.llama3_2_3b.zero_noise"]
    assert ident["zero_noise_identity"] == ident["traced_zero_identity"] \
        == 1.0
    base = json.loads((ROOT / "BENCH_kernels.json").read_text())["records"]
    # CPU timings ("us") are not compared
    base = {k: {f: x for f, x in v.items() if f != "us"}
            for k, v in base.items() if k.startswith("noise.")}
    assert sorted(base) == sorted(records)
    assert len([p for p in cr.flatten(base) if cr.classify(p)[0]]) == 18
    assert cr.compare({"records": records}, {"records": base}, 0.25,
                      2.0) == []

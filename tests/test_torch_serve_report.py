"""Parity of the port's serving report path with the reference: the
per-layer A/D census (``pim.backend.ad_ops_tally``), the serve report
(``telemetry.serve_report``) and ``launch.serve --energy-report``,
``Runtime.save``, and ``benchmarks/serve_bench_torch.py`` against the
committed ``BENCH_serve.json``.

The reference's weights go into the port through ``convert.from_jax``;
compute is f32 wherever the reference runs too (bf16 ``fake_quant`` does
not run on JAX's CPU backend).  Census values, greedy tokens and
per-request A/D ops must be identical.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core import quant_state as jqs  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.pim import ad_ops_tally as jtally  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.telemetry.serve_report import \
    format_energy_report as jformat  # noqa: E402
from repro.telemetry.serve_report import serve_report as jreport  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.core import quant_state as tqs  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.pim import ad_ops_tally  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.telemetry import format_energy_report, serve_report  # noqa: E402

ARCH = "llama3.2-3b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(remat="none", dtype="float32")


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(**F32)
    params = jbuild(cfg)[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(jax_params, backend, **kw):
    params, params_np = jax_params
    over = dict(F32, pim_backend=backend, **kw)
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    return jcfg, tcfg, params, from_jax(params_np, tcfg)


# ---------------------------------------------------------------------------
# the per-layer census
# ---------------------------------------------------------------------------

def test_census_matches_reference(jax_params):
    jcfg, tcfg, params, state = _pair(jax_params, "fake_quant",
                                      scan_layers=False)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 16))
    with jtally() as jt:
        jbuild(jcfg)[1](params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        mode="train")
    rt = trt.compile(tcfg, state, device="cpu", plan=None)
    with ad_ops_tally() as t:
        _, rep = rt.apply({"tokens": toks}, mode="train")
    assert len(t.by_layer) == 7 * tcfg.n_layers
    assert sorted(t.by_layer) == sorted(jt.by_layer)
    for name, ops in t.by_layer.items():
        assert ops.dtype == torch.int64 and ops.dim() == 0
        assert float(ops) == float(jt.by_layer[name]), name
    assert t.total() == jt.total() == rep.total()


@pytest.mark.parametrize("scan", [True, False])
def test_census_of_a_served_trace_sums_to_the_engine_total(scan):
    """Under ``scan_layers=True`` the names are period-local, so each key
    sums its layer over the periods; either way the layers add up to the
    engine's metered total, bit for bit."""
    from repro_torch.models.registry import init
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend="bit_exact",
        scan_layers=scan)
    eng = ServeEngine(trt.compile(cfg, init(cfg, seed=2, device="cpu"),
                                  device="cpu"), max_batch=2, max_len=64)
    rng = np.random.default_rng(4)
    for n in (12, 20, 9):
        eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=3)
    with ad_ops_tally() as t:
        eng.run()
    assert len(t.by_layer) == 7 * (1 if scan else cfg.n_layers)
    assert t.total() == eng.stats()["total_ad_ops"] > 0


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Every aten op a region dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_census_off_adds_no_op_and_no_host_sync(monkeypatch):
    """With no tally open a forward dispatches exactly the ops it did
    before the census existed (the hook replaced by a no-op); an open
    tally adds one ``add`` per repeated name and no host read."""
    from repro_torch.models.registry import init
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend="pallas")
    rt = trt.compile(cfg, init(cfg, seed=1, device="cpu"), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12))

    def forward():
        with _OpLog() as log:
            rt.prefill(toks, max_len=16)
        return log.ops

    now = forward()
    with ad_ops_tally() as t:
        tallied = forward()
    monkeypatch.setattr(tlayers, "record_ad_ops", lambda name, ops: None)
    before = forward()
    assert now == before
    calls = 7 * cfg.n_layers
    extra = list(tallied)
    for op in now:
        extra.remove(op)
    assert extra == ["aten.add"] * (calls - len(t.by_layer))
    assert "aten._local_scalar_dense" not in tallied


# ---------------------------------------------------------------------------
# the serve report and --energy-report
# ---------------------------------------------------------------------------

def _chat(vocab):
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, 24)
    return [np.concatenate([prefix, rng.integers(0, vocab, 8)])
            for _ in range(3)]


TIMED = ("ttft_ms", "latency_ms")


def test_serve_report_matches_reference(jax_params):
    jcfg, tcfg, params, state = _pair(jax_params, "pallas")
    prompts = _chat(tcfg.vocab_size)
    kw = dict(max_batch=2, max_len=64, block_size=16)
    jeng = JServeEngine(jrt.compile(jcfg, params), **kw)
    eng = ServeEngine(trt.compile(tcfg, state, device="cpu"), **kw)
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, max_new_tokens=4)
        e.run()
    want, got = jreport(jeng), serve_report(eng)
    assert [r.generated for r in eng.finished] == \
        [r.generated for r in jeng.finished]
    for key in ("arch", "pim_backend", "paged", "prefix_reuse",
                "block_size", "e_op_pj"):
        assert got[key] == want[key], key
    rows = [{k: v for k, v in r.items() if k not in TIMED}
            for r in got["requests"]]
    assert rows == [{k: v for k, v in r.items() if k not in TIMED}
                    for r in want["requests"]]
    assert [r["reused_prompt_tokens"] for r in rows] == [0, 16, 16]
    for key in ("requests", "decode_tokens", "total_ad_ops",
                "prefill_ad_ops", "decode_ad_ops", "mean_ad_ops_per_request",
                "total_ad_energy_pj", "reused_prompt_tokens"):
        assert got["stats"][key] == want["stats"][key], key
    # one formatter, two reports: the reference prints the port's report
    # as the port does
    assert format_energy_report(got) == jformat(got)


def test_launch_serve_energy_report(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "2", "--pim",
                        "pallas", "--prompt-len", "8", "--shared-prefix",
                        "16", "--max-len", "64", "--energy-report"]) == 0
    out = capsys.readouterr().out
    assert "== serve energy report (llama3.2-3b, pim=pallas, paged=on, " \
        "prefix_reuse=on) ==" in out
    table = out.split("energy_pJ\n", 1)[1].splitlines()[:3]
    assert [ln.split()[0] for ln in table] == ["0", "1", "2"]
    assert [ln.split()[2] for ln in table] == ["0", "16", "16"]


# ---------------------------------------------------------------------------
# Runtime.save
# ---------------------------------------------------------------------------

REGS = dict(delta_r1=0.375, bias=3.0, n_r1=3, n_r2=5, m=2, nu=2,
            signed=True)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_runtime_save_files_cross_load(jax_params, tmp_path, writer):
    jcfg, tcfg, params, state = _pair(jax_params, "fake_quant")
    names = ["layer_0/attn/wq", "layer_1/mlp/w_down"]
    jstate = jqs.QuantState(
        rules=tuple((f"^{n}$", jmake(**REGS)) for n in names),
        default=jmake(delta_r1=2.0, n_r1=6, n_r2=6, m=4, signed=True))
    tstate = tqs.QuantState(
        rules=tuple((f"^{n}$", tmake(**REGS)) for n in names),
        default=tmake(delta_r1=2.0, n_r1=6, n_r2=6, m=4, signed=True))
    if writer == "port":
        rt = trt.compile(tcfg, state, device="cpu", quant_state=tstate,
                         plan=None)
        path = rt.save(str(tmp_path))
        back = jqs.load_quant_state(path)
        assert jqs.quant_state_to_dict(back) == \
            tqs.quant_state_to_dict(tstate)
    else:
        rj = jrt.compile(jcfg, params, quant_state=jstate, plan=None)
        path = rj.save(str(tmp_path))
        back = tqs.load_quant_state(path)
        assert tqs.quant_state_to_dict(back) == \
            jqs.quant_state_to_dict(jstate)
    assert path == str(tmp_path / "quant_state.json")
    assert trt.compile(tcfg, state, device="cpu").save(
        str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the serve bench against the committed baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quick_bench():
    """``serve_bench_torch --quick`` on the CPU with the reference's weights
    of each arch (bf16 ``fake_quant``, the configuration
    ``BENCH_serve.json`` was recorded in): the fresh report and the
    baseline's scenarios."""
    import importlib
    sb = importlib.import_module("benchmarks.serve_bench_torch")

    def reference_weights(cfg):
        jcfg = jget_config(cfg.name, smoke=True).replace(
            remat="none", pim_backend="fake_quant")
        params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
        return from_jax(jax.tree.map(np.asarray, params), cfg)

    fresh = sb.run(quick=True, device="cpu", weights=reference_weights)
    base = json.loads((ROOT / "BENCH_serve.json").read_text())["scenarios"]
    return fresh, base


def test_serve_bench_quick_counts_equal_the_committed_baseline(quick_bench):
    """The quick bench gives the baseline's conversion counts through
    ``check_regression``; timings are not compared."""
    import importlib
    cr = importlib.import_module("benchmarks.check_regression")
    fresh, base = quick_bench
    assert (fresh["backend"], fresh["width"]) == ("fake_quant", "smoke")

    def counts(rec):
        return {k: v for k, v in rec.items()
                if not isinstance(v, dict) and cr.classify(k)[1] != "timing"}

    subset = {"scenarios": {
        "shared_prefix_chat": counts(base["shared_prefix_chat"]),
        "long_context": counts(base["long_context"]),
        "mixed_archs": {"archs": {ARCH: counts(
            base["mixed_archs"]["archs"][ARCH])}}}}
    gated = [p for p in cr.flatten(subset) if cr.classify(p)[0]]
    assert len(gated) == 17
    assert cr.compare(fresh, subset, 0.25, 2.0) == []
    sc = fresh["scenarios"]
    assert sc["shared_prefix_chat"]["total_ad_ops"] == 1_444_352
    assert sc["mixed_archs"]["archs"][ARCH]["total_ad_ops"] == 745_472
    # the quick scenario serves both of the reference's quick archs
    assert "pending_archs" not in sc["mixed_archs"]


def test_serve_bench_quick_rwkv6_counts_equal_the_committed_baseline(
        quick_bench):
    """mixed_archs' rwkv6-7b part: the baseline's counts exactly, and every
    gated number through ``check_regression``; the scenario's aggregates
    are over both archs, as the reference's."""
    import importlib
    cr = importlib.import_module("benchmarks.check_regression")
    fresh, base = quick_bench
    rwkv = "rwkv6-7b"
    got = fresh["scenarios"]["mixed_archs"]
    assert got["archs"][rwkv]["total_ad_ops"] == 1_300_992
    assert got["archs"][rwkv]["prefill_ad_ops"] == 1_114_624
    want = base["mixed_archs"]
    subset = {"scenarios": {"mixed_archs": {
        "archs": {rwkv: {k: v for k, v in want["archs"][rwkv].items()
                         if cr.classify(k)[1] != "timing"}},
        "mean_ad_ops_per_request": want["mean_ad_ops_per_request"]}}}
    gated = [p for p in cr.flatten(subset) if cr.classify(p)[0]]
    assert len(gated) == 6
    assert cr.compare(fresh, subset, 0.25, 2.0) == []
    assert got["mean_ad_ops_per_request"] == \
        want["mean_ad_ops_per_request"]


def test_bench_trace_tokens_match_reference_with_and_without_reuse(
        jax_params):
    """On the serve bench's shared-prefix trace (quick, f32, ``pallas``) the
    port's greedy tokens equal the reference's with prefix reuse on and
    with it off.  The two modes differ from each other in both packages:
    the suffix-only prefill quantizes with suffix-local dynamic scales,
    and a decode batch shares its scales across requests, so greedy tokens
    under reuse are a reading of the bench, not an invariant."""
    import importlib
    sb = importlib.import_module("benchmarks.serve_bench_torch")
    jcfg, tcfg, params, state = _pair(jax_params, "pallas")
    prompts = sb.chat_prompts(tcfg.vocab_size, quick=True)
    rj = jrt.compile(jcfg, params)
    rt = trt.compile(tcfg, state, device="cpu")
    got = {}
    for reuse in (True, False):
        runs = []
        for eng in (JServeEngine(rj, max_batch=2, max_len=128,
                                 prefix_reuse=reuse),
                    ServeEngine(rt, max_batch=2, max_len=128,
                                prefix_reuse=reuse)):
            reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
            eng.run()
            runs.append(([list(r.generated) for r in reqs],
                         [r.ad_ops for r in reqs]))
        assert runs[0] == runs[1]
        got[reuse] = runs[1][0]
    assert got[True] != got[False]

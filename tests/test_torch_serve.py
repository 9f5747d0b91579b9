"""Serving parity of the port (``repro_torch.serve``, ``repro_torch.runtime``,
``repro_torch.launch.serve``) with the reference engine.

The reference ``ServeEngine`` (JAX, CPU, ``pallas`` in interpret mode) and
the port's (``device="cpu"``: the kernel's plain version) serve the same
shared-prefix trace from the same weights: greedy tokens and per-request
A/D-op counts must be identical.  Within the port, the paged engine must
equal the dense slot engine bit for bit.  Compute is f32 against the
reference (bf16 ``fake_quant`` does not run on JAX's CPU backend) and bf16
within the port.
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

ARCH = "llama3.2-3b"


def _prompts(vocab, n=3, prefix_len=24, tail_len=8, seed=5):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    return [np.concatenate([prefix, rng.integers(0, vocab, tail_len)])
            for _ in range(n)]


def _serve(engine, prompts, max_new=4, temperature=0.0):
    reqs = [engine.submit(p, max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    engine.run()
    return reqs


def test_engine_tokens_and_ad_ops_match_reference():
    over = dict(remat="none", dtype="float32", pim_backend="pallas")
    jcfg = jget_config(ARCH, smoke=True).replace(**over)
    params = jbuild(jcfg)[0](jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, smoke=True).replace(**over)
    state = from_jax(jax.tree.map(np.asarray, params), tcfg)
    # the reference's jitted decode can differ from its own eager forward
    # by one quantizer step (XLA fusion numerics); the trace of seed 5 hits
    # such a step at its third request, where the port matches the eager
    # reference.  This trace hits none.
    prompts = _prompts(tcfg.vocab_size, seed=6)
    kw = dict(max_batch=2, max_len=64, block_size=16)
    ref = _serve(JServeEngine(jrt.compile(jcfg, params), **kw), prompts)
    eng = ServeEngine(trt.compile(tcfg, state, device="cpu"), **kw)
    got = _serve(eng, prompts)
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == [r.prefill_ad_ops for r in ref]
    assert [r.reused_tokens for r in got] == [0, 16, 16]
    assert eng.stats()["total_ad_ops"] == sum(r.ad_ops for r in ref)


@pytest.mark.parametrize("backend", ["pallas", "exact"])
def test_paged_engine_bitwise_equals_dense(backend):
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend=backend)
    rt = trt.compile(cfg, init(cfg, seed=3, device="cpu"), device="cpu")
    prompts = _prompts(cfg.vocab_size, n=4)
    runs = {}
    for paged in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, paged=paged,
                          prefix_reuse=False)
        runs[paged] = [(r.generated, r.ad_ops)
                       for r in _serve(eng, prompts, max_new=5)]
    assert runs[True] == runs[False]


def test_prefix_reuse_saves_ad_ops_and_keeps_tokens():
    cfg = get_config(ARCH, smoke=True).replace(
        remat="none", param_dtype="bfloat16", pim_backend="pallas")
    rt = trt.compile(cfg, init(cfg, seed=4, device="cpu"), device="cpu")
    prompts = _prompts(cfg.vocab_size, n=3, prefix_len=40)
    out = {}
    for reuse in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64, prefix_reuse=reuse)
        reqs = _serve(eng, prompts)
        out[reuse] = ([r.generated for r in reqs], eng.stats())
    assert out[True][0] == out[False][0]
    assert out[True][1]["reused_prompt_tokens"] == 2 * 48
    assert out[True][1]["prefill_ad_ops"] < out[False][1]["prefill_ad_ops"]


def test_temperature_sampling_is_seeded():
    cfg = get_config(ARCH, smoke=True).replace(remat="none",
                                               pim_backend="exact")
    rt = trt.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu")
    prompts = _prompts(cfg.vocab_size, n=2)
    toks = [[r.generated for r in _serve(
        ServeEngine(rt, max_batch=2, max_len=64, rng_seed=seed), prompts,
        max_new=6, temperature=1.0)] for seed in (7, 7, 8)]
    assert toks[0] == toks[1] and toks[0] != toks[2]


def test_compile_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    cfg = get_config(ARCH, smoke=True)
    state = init(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.compile(cfg, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", ARCH, "--smoke"])
    assert trt.compile(cfg, state, device="cpu").device.type == "cpu"


def test_init_without_a_device_builds_on_the_card(monkeypatch):
    """``init`` defaults to the card like every entry point: without one
    it raises unless the CPU is asked for."""
    cfg = get_config(ARCH, smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(cfg, seed=0)
    state = init(cfg, seed=0, device="cpu")
    assert all(v.device.type == "cpu" for v in state.values())


def test_with_overrides_shares_or_reprograms_the_plan():
    cfg = get_config(ARCH, smoke=True).replace(pim_backend="pallas")
    rt = trt.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu")
    assert rt.with_overrides().plan is rt.plan
    fq = rt.with_overrides(backend="fake_quant")
    assert fq.plan.backend == "fake_quant" and fq.model is rt.model
    with pytest.raises(KeyError, match="registered"):
        rt.with_overrides(backend="palas")
    assert rt.with_overrides(plan=False).plan is None


def test_launch_serve_cli_runs_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--max-new", "3", "--pim",
                        "pallas", "--shared-prefix", "16", "--prompt-len",
                        "8", "--max-len", "64"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out


# the reference configs whose fields mark a recurrent mixer (rwkv6, jamba's
# mamba), an encoder (whisper) or a patch frontend (internvl2)
GATE_ARCHS = ["llama3.2-3b", "rwkv6-7b", "jamba-v0.1-52b", "whisper-medium",
              "internvl2-76b"]


def _port_config(arch):
    """The reference's smoke config of ``arch``, field for field, as a port
    ``ModelConfig`` (the port's registry holds only llama)."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig, TRQConfig
    jcfg = jget_config(arch, smoke=True)
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["trq"] = TRQConfig(**dataclasses.asdict(jcfg.trq))
    return jcfg, ModelConfig(**kw)


@pytest.mark.parametrize("arch", GATE_ARCHS)
def test_prefix_reuse_gate_matches_the_reference(arch):
    """Reuse stays on only where every mixer is attention, with no encoder
    and no frontend: the port's gate equals the reference's ``_attn_only``
    on each config, and the engine applies it."""
    import types
    from repro.serve.engine import _attn_only as jattn_only
    from repro_torch.serve.engine import _attn_only
    jcfg, cfg = _port_config(arch)
    assert _attn_only(cfg) == jattn_only(jcfg) == (arch == "llama3.2-3b")
    stub = types.SimpleNamespace(cfg=cfg, plan=None, quant_state=None,
                                 device=torch.device("cpu"))
    eng = ServeEngine(stub, max_batch=1, max_len=32, prefix_reuse=True)
    assert eng.prefix_reuse == _attn_only(cfg)

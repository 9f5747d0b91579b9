"""The reference's last four LM configs in the port: deepseek-7b (MHA),
glm4-9b (two KV heads, an untied 151,552-wide head at full width),
deepseek-67b and internvl2-76b (the dense decoder behind a patch
frontend), each at its smoke config against the JAX reference.

The reference's weights go into the port through ``convert.from_jax``;
compute is f32 on both sides (bf16 ``fake_quant`` does not run on JAX's
CPU backend).  Logits agree at rtol=atol=1e-5 on inputs that cross no
rounding boundary.  The two packages sum in another f32 order, so now and
then a value lands on the other side of one: on ``pallas`` an f32 partial
sum crosses a quantizer step (prefill or decode logits off by up to 0.1,
for 4 to 12 of 30 token seeds by arch), and on ``exact`` a decode step's
K/V row rounds into the bf16 cache one bf16 ulp apart (off by up to 2e-3,
for 6 to 13 of 30; none of 20 with f32 caches on both sides, and llama's
smoke config shows it too).  Seed 1 crosses none on any arch and backend.
A/D-op counts are equal on every seed.
internvl2's patch rows are seeded N(0, 1) embeddings (non-zero, so the
frontend's datapath is read), and the engine feeds the reference
launcher's stub of 8 zero embeddings a prefill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.models.registry import ARCHS as JARCHS  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.convert import from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import frames_stub  # noqa: E402
from repro_torch.models.registry import (ARCHS, build_model,  # noqa: E402
                                         get_config, init)
from repro_torch.pim.plan import prepare_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DENSE = ["deepseek-7b", "glm4-9b", "deepseek-67b", "internvl2-76b"]
VLM = "internvl2-76b"
TOL = 1e-5
KW = dict(max_batch=2, max_len=64, block_size=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's torch ops on one thread: the driver's parallel
    run oversubscribes the CPU, and each small op's OpenMP barrier then
    waits for threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}
_PAIRS: dict = {}


def _over(backend):
    return dict(remat="none", dtype="float32", pim_backend=backend)


def _params(arch):
    """The reference's f32 smoke weights, drawn once per module."""
    if arch not in _PARAMS:
        cfg = jget_config(arch, smoke=True).replace(**_over("exact"))
        params = jbuild(cfg)[0](jax.random.PRNGKey(0))
        _PARAMS[arch] = params, jax.tree.map(np.asarray, params)
    return _PARAMS[arch]


def _pair(arch, backend):
    """The reference's and the port's Runtime on ``backend``, built once
    per module (the reference's jitted entry points compile once)."""
    if (arch, backend) not in _PAIRS:
        params, params_np = _params(arch)
        jcfg = jget_config(arch, smoke=True).replace(**_over(backend))
        tcfg = get_config(arch, smoke=True).replace(**_over(backend))
        _PAIRS[arch, backend] = (
            jrt.compile(jcfg, params),
            trt.compile(tcfg, from_jax(params_np, tcfg), device="cpu"))
    return _PAIRS[arch, backend]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _patches(cfg, b: int, f: int, seed: int = 5):
    """Seeded N(0, 1) patch embeddings (non-zero)."""
    return np.random.default_rng(seed).standard_normal(
        (b, f, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_every_reference_arch_is_in_the_port(smoke):
    """The registry holds every arch of the reference's, and the four
    configs of this slice are the reference's field for field."""
    import dataclasses
    assert set(ARCHS) == set(JARCHS)
    for arch in DENSE:
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(jget_config(arch, smoke))


@pytest.mark.parametrize("arch", DENSE)
def test_weights_convert_and_init_draws_at_the_reference_scale(arch):
    """``from_jax`` carries every leaf, ``frontend.patch_proj.w`` and the
    untied ``lm_head.w`` among them (top-level leaves), and the port's
    seeded init draws those two at ``init_linear``'s N(0, 1) * d**-0.5,
    as the reference's init does."""
    _, params_np = _params(arch)
    cfg = get_config(arch, smoke=True)
    state = from_jax(params_np, cfg)
    ours = init(cfg, seed=0, device="cpu")
    keys = set(build_model(cfg).state_dict())
    assert set(state) == keys == set(ours)
    heads = ["lm_head.w"] + (["frontend.patch_proj.w"] if arch == VLM
                             else [])
    assert all(k in keys for k in heads)
    for key in heads:
        want = params_np
        for part in key.split("."):
            want = want[part]
        np.testing.assert_array_equal(state[key].numpy(), want)
        scale = cfg.d_model ** -0.5
        assert abs(float(ours[key].std()) / scale - 1) < 0.05
        assert abs(float(np.std(want)) / scale - 1) < 0.05


@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match_reference(arch, backend):
    """A batch-2 prefill (internvl2's after 8 seeded patch rows) and two
    decode steps: logits within 1e-5, A/D ops equal, the cache's length
    counting the patch rows."""
    rj, rt = _pair(arch, backend)
    cfg = rt.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    extra = {"embeds": _patches(cfg, 2, 8)} if arch == VLM else None
    f = 8 if extra else 0
    (lj, cj), repj = rj.prefill(toks[:, :8], extra, max_len=32)
    (lt, ct), rept = rt.prefill(toks[:, :8], extra, max_len=32)
    _close(lt, lj)
    assert rept.total() == float(repj.ad_ops)
    assert (rept.total() > 0) == (backend == "pallas")
    assert ct["len"].tolist() == [8 + f] * 2
    for step in (8, 9):
        (lj, cj), repj = rj.decode(toks[:, step:step + 1], cj)
        (lt, ct), rept = rt.decode(toks[:, step:step + 1], ct)
        _close(lt, lj)
        assert rept.total() == float(repj.ad_ops)
    assert ct["len"].tolist() == [10 + f] * 2


def test_patch_frontend_train_logits_and_mvm_match_reference():
    """The whole-sequence forward over 6 seeded patch rows and 5 tokens
    (11 positions) and ``Runtime.mvm("frontend/patch_proj")`` on
    ``pallas``; a decoder-only model without a frontend has no such layer
    and takes no ``embeds``."""
    rj, rt = _pair(VLM, "pallas")
    cfg = rt.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 5))
    batch = {"tokens": toks.astype(np.int32),
             "embeds": _patches(cfg, 1, 6, seed=100)}
    (lj, _, _), repj = rj.apply(batch)
    (lt, _, _), rept = rt.apply(batch)
    assert lt.shape == (1, 11, cfg.vocab_size)
    _close(lt, lj)
    assert rept.total() == float(repj.ad_ops)

    x = _patches(cfg, 1, 3, seed=8)[0]
    yj, repj = rj.mvm(jax.numpy.asarray(x), "frontend/patch_proj")
    yt, rept = rt.mvm(torch.from_numpy(x), "frontend/patch_proj")
    _close(yt, yj)
    assert rept.total() == float(repj.ad_ops) > 0

    _, rd = _pair("deepseek-7b", "pallas")
    with pytest.raises(KeyError):
        rd.mvm(torch.from_numpy(x), "frontend/patch_proj")
    with pytest.raises(NotImplementedError, match="embeds"):
        rd.prefill(batch["tokens"], {"embeds": batch["embeds"]}, max_len=16)
    with pytest.raises(ValueError, match="no modality inputs"):
        rt.apply(batch, cache=rt.init_cache(1, 16), mode="decode")


@pytest.mark.parametrize("backend", ["fake_quant", "pallas", "bit_exact"])
def test_frontend_plan_is_bitwise_its_dynamic_path(backend):
    """f32 parameters under bf16 compute: the frontend runs on the f32
    embedding rows, so its plan is frozen at the parameter dtype and the
    planned forward equals the dynamic one bit for bit (the port's
    ``tests/test_plan.py::test_lm_frontend_prepared_bitwise_nonzero_embeds``).
    Frozen at the compute dtype, as every other layer is, it would not
    be."""
    cfg = get_config(VLM, smoke=True).replace(remat="none",
                                              pim_backend=backend)
    assert (cfg.param_dtype, cfg.dtype) == ("float32", "bfloat16")
    state = init(cfg, seed=1, device="cpu")
    planned = trt.compile(cfg, state, device="cpu")
    dynamic = trt.compile(cfg, state, device="cpu", plan=False)
    lp, lq = planned.plan.get("frontend.patch_proj"), \
        planned.plan.get("layers.0.attn.wq")
    if backend == "pallas":
        assert lp.w.dtype == torch.float32 and lq.w.dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 6))
    batch = {"tokens": toks.astype(np.int32), "embeds": _patches(cfg, 1, 5)}
    (la, _, _), ra = dynamic.apply(batch)
    (lb, _, _), rb = planned.apply(batch)
    assert torch.equal(la, lb) and ra.total() == rb.total()

    wrong = trt.compile(cfg, state, device="cpu", plan=prepare_params(
        planned.model, cfg, backend=backend, dtype=torch.bfloat16))
    (lc, _, _), _ = wrong.apply(batch)
    assert not torch.equal(la, lc)


def _jax_stub(cfg, n: int = 8):
    """The reference launcher's ``extra_inputs``
    (``src/repro/launch/serve.py``): n zero embeddings at every prefill
    of a frontend or an encoder."""
    def extra_inputs(b, s):
        if (cfg.frontend in ("patch", "frames") or cfg.encoder_layers > 0) \
                and s > 1:
            return {"embeds": jax.numpy.zeros((b, n, cfg.d_model))}
        return {}
    return extra_inputs


def _trace_prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (12, 7, 14)]


@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_and_ad_ops_match_reference(arch):
    """Three prompts through the paged engine (max batch 2, max_len 64,
    3 new tokens each, greedy) on ``pallas``, with the launcher's stub
    frontend: greedy tokens and per-request A/D ops equal the reference
    engine's, and internvl2's 8 patch rows sit in the cache before each
    prompt's bucket (``cache_len`` = bucket + 8 after the prefill)."""
    rj, rt = _pair(arch, "pallas")
    prompts = _trace_prompts(rt.cfg.vocab_size)
    f = 8 if arch == VLM else 0
    runs = {}
    for name, eng in (
            ("ref", JServeEngine(rj, extra_inputs=_jax_stub(rj.cfg),
                                 **KW)),
            ("port", ServeEngine(rt, extra_inputs=frames_stub(rt.cfg),
                                 **KW))):
        after = {}
        orig = eng._prefill

        def prefill(r, orig=orig, after=after):
            small = orig(r)
            after[r.uid] = r.cache_len
            return small
        eng._prefill = prefill
        reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
        eng.run()
        runs[name] = reqs, after
    (ref, ref_len), (got, got_len) = runs["ref"], runs["port"]
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert [r.ad_ops for r in got] == [r.ad_ops for r in ref]
    assert [r.prefill_ad_ops for r in got] == \
        [r.prefill_ad_ops for r in ref]
    assert got_len == ref_len == {
        i: {12: 16, 7: 8, 14: 16}[len(p)] + f for i, p in enumerate(prompts)}
    assert all(len(r.generated) == 3 and r.ad_ops > 0 for r in got)


@pytest.mark.parametrize("arch", DENSE)
def test_launch_serve_cli_serves_each_arch(arch, capsys):
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "2", "--pim",
                        "pallas", "--prompt-len", "8", "--max-len",
                        "32"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "served 2 requests, 4 tokens" in out

"""Parity of the port's training path (``repro_torch.train``, the
train-mode forward with gradients, ``Runtime.opt_init``/``train_step``,
``data.synthetic.TokenStream``, ``launch.train``) with the JAX reference
``repro.train``.

The reference runs jitted in f32 (its bf16 ``fake_quant`` does not run on
JAX's CPU backend) with no mesh.  Bars: the optimizer on identical
gradients at rtol 1e-6 (and 1e-7 of a leaf's largest value, for values
that cancel to near zero; bf16 moments within one bf16 ulp); one train
step's loss and ``gnorm`` at rtol 1e-5 and every updated parameter at rtol
1e-5, atol 1e-6 (the reference's own resume bars); ``ad_ops`` equal.

The compared step is the reference's step 3: both packages start from the
reference's parameters *and optimizer state* after its steps 0-2
(``convert.from_jax``, ``convert.opt_from_jax``) and take the reference's
``TokenStream`` batch.  From a fresh state the first Adam step is
``lr * g / (|g| + eps)``, about ``lr * sign(g)``: where a gradient is
itself cancellation noise (two f32 summation orders differ by up to 1e-8
here), that step moves its parameter by up to ``lr * dg / eps`` (3e-4
apart at the default eps of 1e-8), and every one of 12 seeds had 1 to 14
such elements; with the second moment of three steps behind it the same
noise moves an update by about ``lr * dg / sqrt(v)``, far under the bar.
The fresh state's step is held on identical gradients
(``test_optimizer_matches_make_optimizer``).  A ``fake_quant`` partial sum
can also land on the other side of a quantizer step (an ulp of another
summation order moves it by a whole step); ``SEED`` fixes inputs whose
compared step hits none (seeds 1 and 3 of 0-6 do on llama3.2-3b, 0, 1, 2
and 5 of 0-6 on granite-moe-3b-a800m).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (from_jax, opt_from_jax, opt_to_jax,  # noqa: E402
                                 to_jax)
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402

LLAMA = "llama3.2-3b"
GRANITE = "granite-moe-3b-a800m"
TC = dict(total_steps=20, warmup_steps=2, checkpoint_every=0)
STEP = 3                          # the compared step: lr 2.98e-4
SEQ, BATCH = 32, 4
SEED = 1                          # the reference's parameters and stream


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: on a CPU shared with other test processes,
    each small op's OpenMP barrier otherwise waits for threads that are
    not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, backend="exact", **kw):
    kw = dict(dtype="float32", remat="none", pim_backend=backend, **kw)
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-6):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@dataclasses.dataclass
class Case:
    """The reference's state after its steps 0 to ``STEP - 1`` and the
    batch of step ``STEP`` (numpy)."""
    jcfg: object
    tcfg: object
    params: dict
    opt: dict
    batch: dict


def _ref_jit(jcfg, tc: JTrainConfig):
    """The reference's step as ``tests/test_train_ckpt.py`` runs it: its
    ``make_train_step`` under ``jax.jit`` (with the config's backend)."""
    from repro.pim.backend import use_backend
    step, opt_init = jloop.make_train_step(jbuild(jcfg)[1], jcfg, tc)

    def run(p, o, b, i):
        with use_backend(jcfg.pim_backend):
            return step(p, o, b, i)
    return jax.jit(run), opt_init


@functools.lru_cache(maxsize=None)
def _case(arch, backend) -> Case:
    """Shared by the tests of one (arch, backend): read only (the ports
    copy what they take)."""
    jcfg, tcfg = _cfgs(arch, backend)
    step, opt_init = _ref_jit(jcfg, JTrainConfig(**TC))
    p = jbuild(jcfg)[0](jax.random.PRNGKey(SEED))
    o = opt_init(p)
    stream = JTokenStream(jcfg.vocab_size, SEQ, BATCH, seed=SEED)
    for i in range(STEP):
        p, o, _ = step(p, o, stream.batch_at(i), i)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return Case(jcfg, tcfg, np_(p), np_(o), np_(stream.batch_at(STEP)))


def _batch_at(jcfg, stream, seed: int, step: int) -> dict:
    """The reference stream's batch as numpy; an encoder-decoder's frames
    are seeded normals ``(B, S, d)`` f32 as ``embeds``."""
    b = jax.tree.map(np.asarray, stream.batch_at(step))
    if jcfg.encoder_layers:
        b["embeds"] = np.random.default_rng((seed, step)).standard_normal(
            b["tokens"].shape + (jcfg.d_model,)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _warm_case(arch, backend, seed, batch, seq):
    """(Case, the reference's params after step ``STEP`` as numpy, its
    metrics): every step, 0 to ``STEP``, through one jitted step, the
    reference ``Runtime``'s (one compile a case).  Read only."""
    jcfg, tcfg = _cfgs(arch, backend)
    p = jbuild(jcfg)[0](jax.random.PRNGKey(seed))
    rj = jrt.compile(jcfg, p, plan=None, tc=JTrainConfig(**TC))
    o = rj.opt_init(p)
    stream = JTokenStream(jcfg.vocab_size, seq, batch, seed=seed)
    for i in range(STEP):
        (p, o, _), _ = rj.train_step(p, o, _batch_at(jcfg, stream, seed, i),
                                     i)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    c = Case(jcfg, tcfg, np_(p), np_(o), _batch_at(jcfg, stream, seed, STEP))
    (p, _, m), _ = rj.train_step(p, o, c.batch, STEP)
    return c, np_(p), {k: float(v) for k, v in m.items()}


def _ref_step(c: Case):
    """The reference's ``Runtime.train_step`` (its jitted step with the
    A/D tally) at ``STEP``: (params, metrics) as numpy."""
    rj = jrt.compile(c.jcfg, c.params, plan=None, tc=JTrainConfig(**TC))
    (p, _, m), _ = rj.train_step(c.params, c.opt, c.batch, STEP)
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


def _port_step(c: Case, tcfg=None, **tc):
    """The port's ``Runtime.train_step`` at ``STEP`` from the case's
    state: (Runtime, params, metrics, report)."""
    tcfg = tcfg or c.tcfg
    rt = trt.compile(tcfg, from_jax(c.params, tcfg), device="cpu",
                     plan=None, tc=TrainConfig(**TC, **tc))
    (p, _, m), rep = rt.train_step(rt.params, opt_from_jax(c.opt), c.batch,
                                   STEP)
    return rt, p, m, rep


# ---------------------------------------------------------------------------
# 1-3: the optimizer, the schedule, the loss
# ---------------------------------------------------------------------------

P = 9                             # stacked layers: factored across at >= 8


def _opt_tree(rng, scale=1.0):
    """A reference-shaped tree: unstacked leaves of rank 2 and 1, stacked
    (P, ...) leaves of rank 2 (norm scales: decayed, factored across the
    P layers), rank 3 (projections) and rank 4 (MoE experts)."""
    def n(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"embed": {"tok": n(40, 16)}, "final_norm": {"scale": n(16)},
            "periods": {"layer_0": {
                "norm1": {"scale": n(P, 16)}, "norm2": {"scale": n(P, 5)},
                "attn": {"wq": {"w": n(P, 16, 24)}, "wk": {"w": n(P, 16, 4)}},
                "moe": {"router": {"w": n(P, 16, 8)},
                        "w_up": n(P, 3, 8, 12)}}}}


@pytest.mark.parametrize("kw", [
    dict(), dict(grad_clip=0.0), dict(optimizer_dtype="bfloat16"),
    dict(factored_second_moment=True),
    dict(factored_second_moment=True, optimizer_dtype="bfloat16",
         grad_clip=0.0)],
    ids=["f32", "no-clip", "bf16-moments", "factored", "factored-bf16"])
def test_optimizer_matches_make_optimizer(kw):
    """Three updates on identical numpy grads (large enough that the clip
    acts where it is on): params, m, v and gnorm against the reference's
    ``make_optimizer`` on its stacked leaves: decay on the stacked rank-1
    norm scales, v factored across the P = 9 layers of ``norm1``
    (16 wide) but not of ``norm2`` (5 wide).  The leaves stay small: XLA
    sums a leaf's squares in f32 in an order that drifts from the exact
    sum by over 1e-6 on leaves of about 14,000 elements, where pairwise
    sums do not."""
    rng = np.random.default_rng(3)
    cfg = get_config(LLAMA, smoke=True).replace(n_layers=P)
    tc = dict(kw, learning_rate=1e-2, weight_decay=0.1)
    jinit, jupdate = jopt.make_optimizer(JTrainConfig(**tc))
    tinit, tupdate = optimizer.make_optimizer(TrainConfig(**tc), cfg)
    params = _opt_tree(rng)
    jp, js = params, jinit(params)
    tp = from_jax(params, cfg)
    ts = tinit(tp)
    if kw.get("factored_second_moment"):
        assert set(ts["v"]["periods/layer_0/norm1/scale"]) == {"row", "col"}
        assert ts["v"]["periods/layer_0/norm1/scale"]["row"].shape == (P,)
        assert torch.is_tensor(ts["v"]["periods/layer_0/norm2/scale"])
    for i in range(3):
        grads = _opt_tree(rng, scale=0.5)
        lr = 1e-2 * (i + 1)
        jp, js, jg = jupdate(grads, js, jp, lr)
        tp, ts, tg = tupdate(from_jax(grads, cfg), ts, tp, lr)
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    assert int(ts["step"]) == int(js["step"]) == 3
    bf16 = kw.get("optimizer_dtype") == "bfloat16"
    for tree_t, tree_j in ((to_jax(tp, cfg), jp), (opt_to_jax(ts), js)):
        got, want = _flat(tree_t), _flat(jax.tree.map(np.asarray, tree_j))
        assert set(got) == set(want)
        for k in want:
            if bf16 and "['m']" in k or bf16 and "['v']" in k:
                # within one bf16 ulp: 2^-7 of the value's binade
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want[k]), 1e-38))) - 7)
                assert np.all(np.abs(got[k] - want[k]) <= ulp), k
            else:
                # f32 at rtol 1e-6; a value that cancels to near zero
                # keeps the absolute error of its operands: 1e-7 of the
                # leaf's largest
                np.testing.assert_allclose(
                    got[k], want[k], rtol=1e-6,
                    atol=1e-7 * float(np.abs(want[k]).max()), err_msg=k)


def test_optimizer_state_round_trips_the_reference_layout():
    """``opt_from_jax(opt_to_jax(state))`` is the state, and the state's
    keys are the reference's tree paths."""
    rng = np.random.default_rng(4)
    cfg = get_config(LLAMA, smoke=True).replace(n_layers=P)
    init, update = optimizer.make_optimizer(
        TrainConfig(factored_second_moment=True), cfg)
    tp = from_jax(_opt_tree(rng), cfg)
    state = init(tp)
    _, state, _ = update(from_jax(_opt_tree(rng), cfg), state, tp, 1e-3)
    back = opt_from_jax(opt_to_jax(state))
    want = jax.tree.map(np.asarray, jopt.make_optimizer(
        JTrainConfig(factored_second_moment=True))[0](_opt_tree(rng)))
    assert set(_flat(opt_to_jax(back))) == set(_flat(want))
    for k, v in _flat(opt_to_jax(state)).items():
        np.testing.assert_array_equal(_flat(opt_to_jax(back))[k], v)


def test_lr_schedule_matches_reference():
    """Exact in f32 at step 0, the end of the warmup, mid-cosine, the end
    and past it."""
    tc = dict(learning_rate=3e-4, warmup_steps=10, total_steps=110)
    want = jopt.lr_schedule(JTrainConfig(**tc))
    got = optimizer.lr_schedule(TrainConfig(**tc))
    for step in (0, 5, 10, 60, 77, 110, 200):
        g = got(step)
        assert g.dtype == torch.float32
        assert float(g) == float(np.float32(want(step))), step


def test_lm_loss_with_aux_matches_reference():
    rng = np.random.default_rng(5)
    logits = (4 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = jloop.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.float32(1.37))
    got = loop.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.tensor(1.37))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) - float(loop.lm_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.0)) == \
        pytest.approx(0.0137, rel=1e-4)


# ---------------------------------------------------------------------------
# 4-7: one train step against the reference's
# ---------------------------------------------------------------------------

def _conversions(cfg) -> int:
    """Conversions of one token row through every ``PimLinear``."""
    from repro_torch.models.registry import build_model
    from repro_torch.pim.plan import iter_linears
    return sum(lin.w.shape[1] * -(-lin.w.shape[0] // 128)
               for _, lin in iter_linears(build_model(cfg)))


@pytest.mark.parametrize("backend", ["exact", "fake_quant"])
@pytest.mark.parametrize("arch", [LLAMA, GRANITE])
def test_train_step_matches_reference(arch, backend):
    """Loss and gnorm at rtol 1e-5, every parameter after the step at rtol
    1e-5, atol 1e-6, ad_ops equal to the reference's ``Runtime`` (7 ops a
    conversion of every token row on ``fake_quant``, none on ``exact``);
    on granite the Switch loss enters the loss, nonzero and equal to the
    reference's."""
    c = _case(arch, backend)
    want_p, want_m = _ref_step(c)
    rt, got_p, got_m, rep = _port_step(c)
    np.testing.assert_allclose(float(got_m["loss"]), want_m["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["gnorm"]), want_m["gnorm"],
                               rtol=1e-5)
    assert float(got_m["lr"]) == want_m["lr"]
    _assert_tree_close(to_jax(got_p, c.tcfg), want_p)
    rows = BATCH * SEQ * (backend == "fake_quant")
    assert rep.total() == float(got_m["ad_ops"]) == want_m["ad_ops"] == \
        7 * rows * _conversions(c.tcfg)
    if arch == GRANITE:
        # the step's Switch loss, on the parameters the step started from
        rj = jrt.compile(c.jcfg, c.params, plan=None)
        (_, _, aux_j), _ = rj.apply({"tokens": c.batch["tokens"]})
        rt0 = trt.compile(c.tcfg, from_jax(c.params, c.tcfg), device="cpu",
                          plan=None)
        (_, _, aux_t), _ = rt0.apply({"tokens": c.batch["tokens"]})
        assert float(aux_j) > 0.5
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


def test_remat_block_is_remat_none():
    """``remat="block"`` recomputes each layer in backward: the same
    parameters (bitwise here, at most 1 ulp allowed) and the same ad_ops,
    each conversion counted once."""
    c = _case(LLAMA, "fake_quant")
    _, p_none, m_none, _ = _port_step(c)
    _, p_block, m_block, rep = _port_step(c, c.tcfg.replace(remat="block"))
    assert float(m_block["loss"]) == float(m_none["loss"])
    for k, v in p_none.items():
        np.testing.assert_array_max_ulp(p_block[k].detach().numpy(),
                                        v.detach().numpy(), maxulp=1)
    assert rep.total() == float(m_none["ad_ops"]) > 0


def test_remat_recompute_is_muted():
    """The recompute runs in backward (the layer is entered twice) and
    adds nothing to the step's ad_ops or to an open census."""
    from repro_torch.pim.backend import ad_ops_tally
    c = _case(LLAMA, "fake_quant")
    tcfg = c.tcfg.replace(remat="block")
    rt = trt.compile(tcfg, from_jax(c.params, tcfg), device="cpu",
                     plan=None, tc=TrainConfig(**TC))
    calls = []
    rt.model.layers[0].register_forward_pre_hook(lambda *a: calls.append(1))
    with ad_ops_tally() as tally:
        (_, _, m), rep = rt.train_step(rt.params, opt_from_jax(c.opt),
                                       c.batch, STEP)
    assert len(calls) == 2
    assert tally.total() == rep.total() == \
        7 * BATCH * SEQ * _conversions(tcfg)


@pytest.mark.parametrize("backend", ["exact", "fake_quant"])
def test_microbatch_matches_one_shot_and_reference(backend):
    """``microbatch=2`` over batch 4 (no clip) against the reference's
    microbatched step, and on ``exact`` against the port's one-shot step:
    the loss at rel 1e-5 and the parameters at rtol 2e-4, atol 2e-5
    (``tests/test_train_ckpt.py``'s bars); ad_ops equal to the one shot's.
    On ``fake_quant`` a microbatch is another quantization (its dynamic
    scales are its own), in both packages: no one-shot comparison.  (The
    reference's ``Runtime`` cannot meter a microbatched step: its scan
    leaks the tally's tracer, so the reference runs ``make_train_step``
    under ``jax.jit``.)"""
    c = _case(LLAMA, backend)
    ref_step, _ = _ref_jit(c.jcfg, JTrainConfig(**TC, microbatch=2,
                                                grad_clip=0.0))
    want_p, _, want_m = ref_step(c.params, c.opt, c.batch, STEP)
    _, p_mb, m_mb, rep_mb = _port_step(c, microbatch=2, grad_clip=0.0)
    _, p_one, m_one, rep_one = _port_step(c, grad_clip=0.0)
    pairs = [(want_m, jax.tree.map(np.asarray, want_p))]
    if backend == "exact":
        pairs.append((m_one, to_jax(p_one, c.tcfg)))
    for m, p in pairs:
        assert float(m_mb["loss"]) == pytest.approx(float(m["loss"]),
                                                    rel=1e-5)
        _assert_tree_close(to_jax(p_mb, c.tcfg), p, rtol=2e-4, atol=2e-5)
    assert rep_mb.total() == rep_one.total() == \
        7 * BATCH * SEQ * _conversions(c.tcfg) * (backend == "fake_quant")


def test_train_step_refuses_backends_without_a_gradient_path():
    cfg = _cfgs(LLAMA, "pallas")[1]
    state = from_jax(jax.tree.map(np.asarray, jbuild(_cfgs(LLAMA)[0])[0](
        jax.random.PRNGKey(0))), cfg)
    rt = trt.compile(cfg, state, device="cpu", plan=None)
    with pytest.raises(ValueError, match="gradient path"):
        rt.opt_init()
    rt = trt.compile(cfg.replace(pim_backend="fake_quant"), state,
                     device="cpu", plan=True)
    with pytest.raises(ValueError, match="plan=None"):
        rt.opt_init()


# ---------------------------------------------------------------------------
# 10-12: the stream, the Trainer, the CLI
# ---------------------------------------------------------------------------

def test_token_stream_is_a_pure_function_of_seed_and_step():
    s1 = TokenStream(1000, 32, 4, seed=5)
    b1 = s1.batch_at(17, "cpu")
    b2 = TokenStream(1000, 32, 4, seed=5).batch_at(17, "cpu")
    assert b1["tokens"].dtype == torch.int32
    assert b1["tokens"].shape == b1["labels"].shape == (4, 32)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], s1.batch_at(18, "cpu")["tokens"])
    assert not torch.equal(
        b1["tokens"], TokenStream(1000, 32, 4, seed=6).batch_at(
            17, "cpu")["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.7])
def test_token_stream_mixes_zipf_and_bigrams(frac):
    """The share of next tokens that follow the bigram map is within 0.05
    of ``bigram_frac`` (a unigram draw matches the map by chance now and
    then); the unigram draw is Zipf-like: token 0 is the most frequent.
    The bigram map is the reference's."""
    s = TokenStream(500, 256, 8, seed=2, bigram_frac=frac)
    np.testing.assert_array_equal(
        s._bigram_map(), JTokenStream(500, 256, 8, seed=2)._bigram_map())
    b = s.batch_at(0, "cpu")
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], 1).numpy()
    follows = seq[:, 1:] == s._bigram_map()[seq[:, :-1]]
    assert abs(follows.mean() - frac) < 0.05
    if frac == 0.0:
        counts = np.bincount(seq.ravel(), minlength=500)
        assert counts.argmax() == 0 and counts[0] > 5 * counts[100:].mean()


def test_trainer_history_and_watchdog():
    """``tests/test_train_ckpt.py``'s Trainer test on the port: a history
    row per step at ``log_every=1``, the median step time, no straggler
    in three steps (the watchdog looks after five)."""
    cfg = get_config(LLAMA, smoke=True).replace(dtype="float32")
    from repro_torch.models.registry import init
    tc = TrainConfig(**TC)
    rt = trt.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                     plan=None, tc=tc)
    stream = TokenStream(cfg.vocab_size, 16, 2, seed=0)
    tr = loop.Trainer(train_step=lambda p, o, b, i: rt.train_step(
        p, o, b, i)[0], batch_at=lambda i: stream.batch_at(i, "cpu"),
        tc=tc, log_every=1)
    _, _, report = tr.run(rt.params, rt.opt_init(), num_steps=3)
    assert [r["step"] for r in report["history"]] == [0, 1, 2]
    assert {"loss", "gnorm", "lr", "ad_ops", "step_time_s"} <= \
        set(report["history"][0])
    assert report["median_step_s"] > 0 and report["stragglers"] == []
    with pytest.raises(ValueError, match="cfg"):
        loop.Trainer(train_step=tr.train_step, batch_at=tr.batch_at, tc=tc,
                     ckpt_dir="x").run(rt.params, rt.opt_init(),
                                       num_steps=1)


def test_train_cli_runs_checkpoints_and_resumes(tmp_path, capsys):
    """``--smoke --device cpu``: three steps with a checkpoint at step 2,
    finite losses; ``--resume`` picks the checkpoint up at step 2 and runs
    step 2 again; the refused arch (internvl2-76b, which the reference
    cannot train either) names the reason's record in the roadmap."""
    ck = str(tmp_path / "ck")
    log = tmp_path / "log.json"
    args = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", ck, "--ckpt-every", "2",
            "--pim", "fake_quant"]
    assert train_cli.main(args + ["--steps", "3", "--log-json",
                                  str(log)]) == 0
    hist = json.loads(log.read_text())["history"]
    assert [r["step"] for r in hist] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_00000002"]
    assert train_cli.main(args + ["--steps", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     2 loss" in out
    for arch in train_cli.REFUSED:
        with pytest.raises(SystemExit):
            train_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
        assert "ROADMAP.md" in capsys.readouterr().err

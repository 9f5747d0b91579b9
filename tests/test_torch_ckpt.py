"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) against the
reference's format (``repro.ckpt.checkpoint``): the same directory layout
(``tmp.<step>`` renamed to ``step_%08d``), manifest (file, shape, dtype
name, crc32 of the raw bytes) and flat ``uint8`` payloads, so bf16
survives and a checkpoint written by either package restores in the other.

The train-state checkpoints hold the reference's tree paths
(``params/periods/layer_0/attn/wq/w``, ``opt/m/...``, ``opt/v/...``,
``opt/step``).  Resume bars are the reference's (rtol 1e-5, atol 1e-6):
the reference trains three steps and saves, the port restores and trains
three more and matches the reference's six straight steps; the port's
checkpoint then loads into the reference's own template exactly.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import from_jax, opt_to_jax, to_jax  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

ARCH = "llama3.2-3b"
TC = dict(total_steps=20, warmup_steps=2, checkpoint_every=0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"a": torch.arange(8.0),
            "b": {"c": torch.linspace(-3, 3, 9).reshape(3, 3).to(
                torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "empty": torch.zeros((0, 4))}


def _equal(x, y):
    """Same dtype, shape and bytes."""
    assert x.dtype == y.dtype and x.shape == y.shape
    assert torch.equal(x.reshape(-1).view(torch.uint8),
                       y.reshape(-1).view(torch.uint8))


def _bytes(a) -> np.ndarray:
    return np.asarray(a).reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def test_round_trip_with_bf16_leaves(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007"
    assert ckpt.latest_step(str(tmp_path)) == 7
    back = ckpt.restore(str(tmp_path), tree)
    _equal(back["a"], tree["a"])
    _equal(back["b"]["c"], tree["b"]["c"])
    _equal(back["step"], tree["step"])
    _equal(back["empty"], tree["empty"])
    flat = ckpt.restore(str(tmp_path))
    assert set(flat) == {"a", "b/c", "step", "empty"}


def test_corruption_detected(tmp_path):
    tree = {"a": torch.arange(64.0)}
    path = ckpt.save(str(tmp_path), 1, tree)
    fname = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, fname))
    arr[0] += 1
    np.save(os.path.join(path, fname), arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), tree)
    ckpt.restore(str(tmp_path), tree, verify=False)


def test_retention_keeps_the_newest(tmp_path):
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004",
                                                 "step_00000005"]


def test_async_snapshots_then_writes(tmp_path):
    """The snapshot is taken at the call: a later in-place update does not
    reach the file."""
    w = torch.full((16,), 3.0)
    ckpt.save_async(str(tmp_path), 2, {"w": w})
    w.add_(1.0)
    ckpt.wait_pending()
    back = ckpt.restore(str(tmp_path), {"w": w})
    assert torch.equal(back["w"], torch.full((16,), 3.0))


def test_keys_must_match_the_template(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"b": None})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"a": None})


def test_either_package_reads_the_others_arrays(tmp_path):
    """The same manifest and payload bytes: the reference restores the
    port's bf16/f32/int32 leaves and the port the reference's."""
    tree = _tree()
    del tree["empty"]
    ckpt.save(str(tmp_path / "port"), 3, tree)
    jt = {"a": jnp.arange(8.0),
          "b": {"c": jnp.linspace(-3, 3, 9).reshape(3, 3).astype(
              jnp.bfloat16)},
          "step": jnp.int32(7)}
    jckpt.save(str(tmp_path / "ref"), 3, jt)
    back_j = jckpt.restore(str(tmp_path / "port"), jt)
    back_t = ckpt.restore(str(tmp_path / "ref"), tree)
    for key in ("a", "step"):
        np.testing.assert_array_equal(np.asarray(back_j[key]),
                                      tree[key].numpy())
        _equal(back_t[key], tree[key])
    assert back_j["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back_j["b"]["c"]).view(np.int16),
        tree["b"]["c"].view(torch.int16).numpy())
    _equal(back_t["b"]["c"], tree["b"]["c"])
    for name in ("port", "ref"):
        with open(tmp_path / name / "step_00000003" / "manifest.json") as f:
            assert '"dtype": "bfloat16"' in f.read()


# ---------------------------------------------------------------------------
# train state across the packages
# ---------------------------------------------------------------------------

def _ref_setup(backend, **tc):
    kw = dict(dtype="float32", remat="none", pim_backend=backend)
    jcfg = jget_config(ARCH, smoke=True).replace(**kw)
    tcfg = get_config(ARCH, smoke=True).replace(**kw)
    from repro.pim.backend import use_backend
    step, opt_init = jloop.make_train_step(
        jbuild(jcfg)[1], jcfg, JTrainConfig(**TC, **tc))

    def run(p, o, b, i):
        with use_backend(backend):
            return step(p, o, b, i)
    return jcfg, tcfg, jax.jit(run), opt_init


@pytest.mark.parametrize("backend", ["exact", "fake_quant"])
def test_reference_checkpoint_resumes_in_the_port_and_back(tmp_path,
                                                           backend):
    """The reference trains steps 0-2 and saves; the port restores into
    its own state, trains steps 3-5 and matches the reference's six
    straight steps (params rtol 1e-5, atol 1e-6); the port then saves, and
    the reference's ``restore`` loads that with its own template, equal
    to the port's state bit for bit."""
    tc = {}
    jcfg, tcfg, step, opt_init = _ref_setup(backend, **tc)
    stream = JTokenStream(jcfg.vocab_size, 32, 4, seed=1)
    p = jbuild(jcfg)[0](jax.random.PRNGKey(1))
    o = opt_init(p)
    for i in range(3):
        p, o, _ = step(p, o, stream.batch_at(i), i)
    jckpt.save(str(tmp_path / "ref"), 3, {"params": p, "opt": o})
    p6, o6 = p, o
    for i in range(3, 6):
        p6, o6, _ = step(p6, o6, stream.batch_at(i), i)

    # the port starts from other weights: everything comes from the file
    other = jbuild(jcfg)[0](jax.random.PRNGKey(9))
    rt = trt.compile(tcfg, from_jax(jax.tree.map(np.asarray, other), tcfg),
                     device="cpu", plan=None, tc=TrainConfig(**TC, **tc))
    params, opt, at = ckpt.restore_train_state(str(tmp_path / "ref"),
                                               rt.params, rt.opt_init(),
                                               tcfg)
    assert at == 3 and int(opt["step"]) == 3
    for i in range(3, 6):
        batch = {k: np.asarray(v) for k, v in stream.batch_at(i).items()}
        (params, opt, _), _ = rt.train_step(params, opt, batch, i)
    got = jax.tree_util.tree_flatten_with_path(to_jax(params, tcfg))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, p6))[0])
    for k, v in got:
        np.testing.assert_allclose(np.asarray(v, np.float32),
                                   np.asarray(want[k], np.float32),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(k))

    ckpt.save_train_state(str(tmp_path / "port"), 6, params, opt, tcfg)
    back = jckpt.restore(str(tmp_path / "port"), {"params": p6, "opt": o6})
    for mine, theirs in ((to_jax(params, tcfg), back["params"]),
                         (opt_to_jax(opt), back["opt"])):
        a = jax.tree_util.tree_flatten_with_path(mine)[0]
        b = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
        assert len(a) == len(b)
        for k, v in a:
            assert np.asarray(b[k]).dtype == v.dtype
            np.testing.assert_array_equal(_bytes(b[k]), _bytes(v))


def test_port_resume_is_exact(tmp_path):
    """Six straight steps equal three, a checkpoint, a restore into a
    fresh Runtime and three more (the port's own loop, bit for bit)."""
    jcfg, tcfg, _, _ = _ref_setup("fake_quant")
    from repro_torch.data.synthetic import TokenStream
    stream = TokenStream(tcfg.vocab_size, 16, 2, seed=0)
    params0 = from_jax(jax.tree.map(np.asarray, jbuild(jcfg)[0](
        jax.random.PRNGKey(0))), tcfg)

    def runtime():
        return trt.compile(tcfg, {k: v.clone() for k, v in params0.items()},
                           device="cpu", plan=None, tc=TrainConfig(**TC))

    def run(rt, p, o, steps):
        for i in steps:
            (p, o, _), _ = rt.train_step(p, o, stream.batch_at(i, "cpu"), i)
        return p, o

    rt = runtime()
    straight, _ = run(rt, rt.params, rt.opt_init(), range(6))
    rt = runtime()
    p, o = run(rt, rt.params, rt.opt_init(), range(3))
    ckpt.save_train_state(str(tmp_path), 3, p, o, tcfg, background=True)
    ckpt.wait_pending()
    rt = runtime()
    p, o, at = ckpt.restore_train_state(str(tmp_path), rt.params,
                                        rt.opt_init(), tcfg)
    resumed, _ = run(rt, p, o, range(at, 6))
    for k, v in straight.items():
        assert torch.equal(resumed[k], v), k


def test_bf16_factored_state_round_trips_through_the_port(tmp_path):
    """bf16 moments and factored second moments (the deepseek-67b and
    arctic-480b overrides): the reference's checkpoint restored by the
    port and saved again is the reference's state bit for bit, under its
    own template.  (Trained on from there, a bf16 moment rounds to one
    side or the other of a bf16 step as an f32 ulp of its gradient goes:
    2^-8 of an update, over the resume bar; the f32 cases continue.)"""
    tc = dict(optimizer_dtype="bfloat16", factored_second_moment=True)
    jcfg, tcfg, step, opt_init = _ref_setup("exact", **tc)
    stream = JTokenStream(jcfg.vocab_size, 32, 4, seed=1)
    p = jbuild(jcfg)[0](jax.random.PRNGKey(1))
    o = opt_init(p)
    for i in range(2):
        p, o, _ = step(p, o, stream.batch_at(i), i)
    jckpt.save(str(tmp_path / "ref"), 2, {"params": p, "opt": o})
    rt = trt.compile(tcfg, from_jax(jax.tree.map(np.asarray, jbuild(jcfg)[0](
        jax.random.PRNGKey(9))), tcfg), device="cpu", plan=None,
        tc=TrainConfig(**TC, **tc))
    params, opt, _ = ckpt.restore_train_state(str(tmp_path / "ref"),
                                              rt.params, rt.opt_init(), tcfg)
    assert opt["m"]["embed/tok"].dtype == torch.bfloat16
    assert set(opt["v"]["embed/tok"]) == {"row", "col"}
    ckpt.save_train_state(str(tmp_path / "port"), 2, params, opt, tcfg)
    back = jckpt.restore(str(tmp_path / "port"), {"params": p, "opt": o})
    a = jax.tree_util.tree_flatten_with_path(back)[0]
    b = dict(jax.tree_util.tree_flatten_with_path({"params": p,
                                                   "opt": o})[0])
    assert len(a) == len(b)
    for k, v in a:
        assert np.asarray(b[k]).dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(_bytes(v), _bytes(b[k]))

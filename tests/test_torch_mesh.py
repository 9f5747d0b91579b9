"""The port on a mesh, on CPU ranks (gloo): a meshed run returns what one
process returns.

(a) In this process, one rank, a ``(1, 1)`` mesh: llama smoke serves on
    ``fake_quant`` and on ``pallas`` (K1's plain version) with logits,
    cache and ``ad_ops`` bitwise equal to the mesh-less run, and
    ``train_setup``'s step equals the mesh-less step bitwise.
(b) Two spawned ranks on ``(2, 1)`` (the data axis splits the batch: each
    rank runs its rows, the dynamic scales, the auto-range maximum and the
    A/D count are reduced over it) and ``(1, 2)`` (the model axis: each
    rank runs every row on its gathered weights): llama smoke on
    ``pallas`` and granite smoke on ``fake_quant`` serve with logits,
    cache, engine tokens, ``ad_ops`` and the per-layer census bitwise
    equal to one process (a local ``amax`` would show here).  On ``(2,
    1)`` one llama ``fake_quant`` train step with ZeRO-1 moments (split
    over 'data') holds at the train suite's bars (rtol 1e-5, atol 1e-6,
    loss at rtol 1e-5, ``ad_ops`` equal).  As in
    ``test_torch_train``, the compared step is step 3, taken from the
    state of three mesh-less steps: a first Adam step is about ``lr *
    sign(g)``, which another summation order of a cancelling gradient
    flips.  The step computes in f32, as the train suite's (a bf16
    weight gradient summed from two ranks' halves rounds twice).  The
    ranks compare against rank 0's mesh-less run, on the same one CPU
    thread: a backward on another number of threads sums its weight
    gradients in another order.

Each spawn has its own time limit (120 s), so a hang fails; the process
group of (a) is destroyed by its fixture's finalizer.
"""
import functools
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.dist.group import destroy, init_local  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.pim.backend import ad_ops_tally  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
TC = dict(total_steps=20, warmup_steps=2, checkpoint_every=0)
TRAIN_STEPS = 4                 # three mesh-less, the compared one meshed
SERVE = (("llama3.2-3b", "pallas"), ("granite-moe-3b-a800m", "fake_quant"))


def _serve(arch, backend, mesh=None):
    """Prefill a 4-row batch, decode a step, and run the engine over two
    requests (decode batch 2): everything a rank returns."""
    cfg = get_config(arch, smoke=True).replace(pim_backend=backend)
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         mesh=mesh)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    (last, cache), rep = rt.prefill(toks, max_len=32)
    nxt = np.argmax(last.numpy(), -1)[:, None].astype(np.int32)
    with ad_ops_tally() as census:
        (dec, cache2), rep2 = rt.decode(nxt, cache)
    eng = ServeEngine(rt, max_batch=2, max_len=64)
    rng = np.random.default_rng(2)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=3)
            for n in (5, 11)]
    eng.run()
    return {"prefill": last, "decode": dec, "prefill_ops": int(rep.ad_ops),
            "decode_ops": int(rep2.ad_ops),
            "cache": {k: v for k, v in cache2.items()},
            "tokens": [r.generated for r in reqs],
            "request_ops": [r.ad_ops for r in reqs],
            "total_ops": eng.total_ad_ops,
            "census": {k: int(v) for k, v in census.by_layer.items()}}


def _train(mesh=None):
    """Steps 0-2 mesh-less, step 3 on ``mesh`` (or mesh-less too)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.sharding import assign
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="fake_quant", remat="block", dtype="float32")
    tc = TrainConfig(**TC)
    stream = TokenStream(cfg.vocab_size, 16, 4)
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         plan=None, tc=tc)
    opt = rt.opt_init()
    for i in range(TRAIN_STEPS - 1):
        (_, opt, m), _ = rt.train_step(rt.params, opt, stream.batch_at(
            i, device="cpu"), i)
    if mesh is not None:
        state = {n: p.detach().clone() for n, p in rt.params.items()}
        rt_m = runtime.compile(cfg, state, device="cpu", plan=None, tc=tc,
                               mesh=mesh)
        step, opt_init, _, o_specs = rt_m.train_setup()
        placed = opt_init()
        for part in ("m", "v"):
            for path, leaf in placed[part].items():
                assign(leaf, opt[part][path])
        placed["step"] = opt["step"]
        _, opt, m = step(rt_m.params, placed, stream.batch_at(
            TRAIN_STEPS - 1, device="cpu"), TRAIN_STEPS - 1)
        params = {n: p.full_tensor().detach() for n, p in rt_m.params.items()}
        moment = opt["m"]["embed/tok"]
        zero1 = (type(moment).__name__, tuple(moment.to_local().shape),
                 str(o_specs["m"]["embed/tok"]))
    else:
        (_, opt, m), _ = rt.train_step(rt.params, opt, stream.batch_at(
            TRAIN_STEPS - 1, device="cpu"), TRAIN_STEPS - 1)
        params = {n: p.detach() for n, p in rt.params.items()}
        zero1 = None
    return {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
            "ad_ops": int(m["ad_ops"]), "params": params, "zero1": zero1}


# ---------------------------------------------------------------------------
# (a) one rank in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def host_mesh():
    init_local("gloo")
    try:
        yield make_host_mesh("cpu")
    finally:
        destroy()


def _assert_same(got, want):
    for key in ("prefill", "decode"):
        assert torch.equal(got[key], want[key]), key
    for key in ("prefill_ops", "decode_ops", "tokens", "request_ops",
                "total_ops", "census"):
        assert got[key] == want[key], key
    assert set(got["cache"]) == set(want["cache"])
    for key, leaf in want["cache"].items():
        assert torch.equal(got["cache"][key], leaf), key


@pytest.mark.parametrize("backend", ["fake_quant", "pallas"])
def test_one_rank_mesh_serves_bitwise(host_mesh, backend):
    assert tuple(host_mesh.shape) == (1, 1)
    got = _serve("llama3.2-3b", backend, host_mesh)
    _assert_same(got, _serve("llama3.2-3b", backend))
    assert got["decode_ops"] > 0


def test_one_rank_mesh_train_setup_step_is_bitwise(host_mesh):
    got, want = _train(host_mesh), _train()
    assert got["loss"] == want["loss"] and got["ad_ops"] == want["ad_ops"]
    assert got["gnorm"] == want["gnorm"]
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
    assert got["zero1"][0] == "DTensor"


def test_train_setup_needs_a_mesh():
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="fake_quant")
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         plan=None)
    with pytest.raises(ValueError, match="mesh"):
        rt.train_setup()


# ---------------------------------------------------------------------------
# (b) two spawned ranks
# ---------------------------------------------------------------------------

_WORKER = """
import sys
sys.path[:0] = [sys.argv[6], sys.argv[7]]
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.dist.group import destroy, init_local
import test_torch_mesh as t
rank, world, store, shape, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
init_local("gloo", world, rank, store, timeout_s=60)
try:
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(
        tuple(int(x) for x in shape.split("x"))),
        mesh_dim_names=("data", "model"))
    # every rank runs the meshed program; rank 0 also the mesh-less one
    runs = (mesh, None) if rank == 0 else (mesh,)
    res = {(arch, m is None): t._serve(arch, be, m)
           for arch, be in t.SERVE for m in runs}
    if shape == "2x1":
        for m in runs:
            res["train", m is None] = t._train(m)
    torch.save(res, f"{out}.{rank}")
finally:
    destroy()
"""


@functools.lru_cache(maxsize=None)
def _spawned(shape: str) -> list:
    """Both ranks' results on a ``shape`` mesh of two gloo ranks."""
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "res")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "2",
         os.path.join(tmp, "store"), shape, out, str(ROOT / "src"),
         str(ROOT / "tests")], env=env, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return [torch.load(f"{out}.{r}") for r in range(2)]


@pytest.mark.parametrize("arch,backend", SERVE)
@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_two_ranks_serve_bitwise(shape, arch, backend):
    ranks = _spawned(shape)
    for res in ranks:
        _assert_same(res[arch, False], ranks[0][arch, True])


def test_two_ranks_train_step_with_zero1():
    """On (2, 1): the data axis splits the batch and shards the moments."""
    shape = "2x1"
    ranks = _spawned(shape)
    for res in ranks:
        got, want = res["train", False], ranks[0]["train", True]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-5)
        assert got["ad_ops"] == want["ad_ops"]
        for name, p in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       p.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        kind, local, spec = got["zero1"]
        assert kind == "DTensor"
        # the embedding is vocab-parallel over 'model'; ZeRO-1 adds 'data'
        # on its free dim, d_model: each rank holds its block of both
        assert spec == "P('model', 'data')"
        cfg = get_config("llama3.2-3b", smoke=True)
        assert local == (cfg.vocab_size, cfg.d_model // 2)


def test_one_process_references_agree_across_processes():
    """Rank 0's mesh-less reference is the same run as this process's for
    the serving paths (forward only)."""
    for arch, backend in SERVE:
        _assert_same(_spawned("2x1")[0][arch, True], _serve(arch, backend))

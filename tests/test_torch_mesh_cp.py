"""The reference's context-parallel layout (``parallelism="fsdp_cp"``) on
the port's mesh: under it the model axis splits the sequence, and the
result is still what one process returns, bit for bit.

(a) K1's split launch in its plain version: the rows in 2 and 4 blocks,
    pass 1 on each block, the maximum cells max-reduced, pass 2 on each
    block: ``y`` and the op count equal one auto-ranged call on all the
    rows bitwise, and the reference's ``trq_group_mvm`` (interpret mode)
    at one small shape.
(b) The port's attention on a q block at its offset (``chunked_attention
    (q_off=)``, ``full_attention(q_off=)``) against the reference's
    ``chunked_attention(..., context_parallel=True)`` and ``full_attention
    (q_off=)`` on the whole sequence, rows of the block, at rtol = atol =
    1e-5 in f32.
(c) Two spawned gloo ranks on ``(1, 2)``: llama3.2-3b smoke serves a
    trace (a prefill, a continued prefill, a decode, and the engine over
    two requests that share a prefix, so that it reuses it) on ``pallas``
    and on ``bit_exact``, and takes one ``fake_quant`` train step (as in
    ``test_torch_mesh``, step 3 from three mesh-less steps, remat
    ``block``), its backward on another thread than its forward, as a
    card's autograd runs it.  Tokens, logits, caches, the A/D counts (per
    call, per request, per layer) and the loss are bitwise one process's.
    The parameters after the step are held at ``test_torch_mesh``'s
    data-split bar: every weight gradient is a sum over the rows, which a
    split adds in another order (ROADMAP §3).
(d) internvl2-76b smoke prefills its 16 patch rows and 16 tokens on
    ``(1, 2)`` (the split cuts the F + S rows), bitwise.
(e) Four ranks on ``(2, 2)`` serve the llama trace on ``pallas`` and take
    the train step as in (c), batch and sequence split.

On the card (``cuda`` marker; skips here): K1's split launch against one
call, and rmsnorm's rows against a call on fewer rows.

Each rank records what it brings to the four reductions (the activation
maximum, K1's maximum cells, the A/D sum, the loss); the tests check that
the ranks' own values differ, so a rank-local reduction would change the
results above.  The spawns run at once, each under its own time limit
(150 s), on one intra-op thread; the ranks compare against rank 0's
mesh-less run.
"""
import contextlib
import functools
import os
import pathlib
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime  # noqa: E402
from repro_torch.dist import group  # noqa: E402
from repro_torch.kernels.trq_group_mvm import ops as k1_ops  # noqa: E402
from repro_torch.kernels.trq_group_mvm import ref as k1_ref  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402
from repro_torch.pim.backend import ad_ops_tally  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_STEPS = 4                 # test_torch_mesh._train's: each a backward
SPAWN_TIMEOUT_S = 150
MAX_LEN = 48


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

def _serve(arch, backend, mesh=None):
    """A prefill of 4 x 16 tokens, a continued prefill of 8, a decode, and
    the engine over two 32-token requests sharing their first 20 tokens
    (the second reuses the first's leading block)."""
    cfg = get_config(arch, smoke=True).replace(pim_backend=backend)
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         mesh=mesh)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    with ad_ops_tally() as census:
        (last, cache), rep = rt.prefill(toks, max_len=MAX_LEN)
    more = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, 24, dtype=np.int32), (4, 8))
    (cont, cache), rep_c = rt.prefill_cont(more, pos, cache)
    nxt = torch.argmax(cont, -1)[:, None].to(torch.int32)
    (dec, cache), rep_d = rt.decode(nxt, cache)
    eng = ServeEngine(rt, max_batch=4, max_len=64)
    prefix = rng.integers(0, cfg.vocab_size, 20)
    reqs = [eng.submit(np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, 12)]), max_new_tokens=3) for _ in range(2)]
    eng.run()
    return {"logits": (last, cont, dec),
            "ops": (int(rep.ad_ops), int(rep_c.ad_ops), int(rep_d.ad_ops)),
            "cache": dict(cache),
            "census": {k: int(v) for k, v in census.by_layer.items()},
            "tokens": [r.generated for r in reqs],
            "reused": [r.reused_tokens for r in reqs],
            "request_ops": [r.ad_ops for r in reqs]}


def _vlm(mesh=None):
    """internvl2 smoke: 16 patch rows before 16 tokens, on pallas."""
    cfg = get_config("internvl2-76b", smoke=True).replace(
        pim_backend="pallas")
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         mesh=mesh)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    emb = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    (last, cache), rep = rt.prefill(toks, {"embeds": emb}, max_len=64)
    return {"logits": (last,), "ops": (int(rep.ad_ops),),
            "cache": dict(cache), "rows": cfg.frontend_len + 16}


def _record():
    """Wrap the split reductions and the loss gather to keep, in call
    order, what this rank brings to them: ``("max", x)`` (activation and
    partial-sum maxima), ``("cells", x)`` (K1's maximum cells),
    ``("sum", x)`` (A/D counts) and ``("loss", x)`` (its token terms'
    mean)."""
    import torch.distributed as dist
    seen = []
    reduce, gather = group.reduce_over_split, group.gather_tokens

    def reduce_rec(t, op):
        kind = "sum" if op == dist.ReduceOp.SUM else \
            "cells" if t.dtype == torch.int32 else "max"
        seen.append((kind, t.clone()))
        return reduce(t, op)

    def gather_rec(t):
        seen.append(("loss", t.mean()))
        return gather(t)
    group.reduce_over_split, group.gather_tokens = reduce_rec, gather_rec
    return seen


def _train(mesh=None):
    import test_torch_mesh
    return test_torch_mesh._train(mesh)


@contextlib.contextmanager
def _backward_on_another_thread():
    """Run every ``torch.autograd.grad`` on a thread of its own, as
    autograd runs a CUDA graph's backward on its device thread: the
    rematerialised layers' recompute (the train step's ``remat="block"``)
    then starts from that thread's own, empty, mesh state.  Yields the
    ident of each call's thread."""
    import threading
    grad, idents = torch.autograd.grad, []

    def on_thread(*a, **k):
        box = {}

        def run():
            idents.append(threading.get_ident())
            try:
                box["out"] = grad(*a, **k)
            except BaseException as e:           # raised in the caller
                box["err"] = e
        th = threading.Thread(target=run)
        th.start()
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    torch.autograd.grad = on_thread
    try:
        yield idents
    finally:
        torch.autograd.grad = grad


def _worker(shape: str, mesh, rank: int) -> dict:
    """Everything one rank returns for ``shape``: each run on the mesh
    and, on rank 0, without one."""
    runs = (mesh, None) if rank == 0 else (mesh,)
    res = {}
    for m in runs:
        seen = _record() if m is not None else None
        res["pallas", m is None] = _serve("llama3.2-3b", "pallas", m)
        if shape == "1x2":
            res["bit_exact", m is None] = _serve("llama3.2-3b", "bit_exact",
                                                 m)
            res["vlm", m is None] = _vlm(m)
        if m is None:
            res["train", True] = _train()
        else:
            with _backward_on_another_thread() as idents:
                res["train", False] = _train(m)
            res["backward_threads"] = sum(i != threading.get_ident()
                                          for i in idents)
        if seen is not None:
            res["seen"] = seen
            group.reduce_over_split = _REDUCE
            group.gather_tokens = _GATHER
    return res


_REDUCE, _GATHER = group.reduce_over_split, group.gather_tokens

_SPAWN = """
import sys
sys.path[:0] = [sys.argv[6], sys.argv[7]]
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.dist.group import destroy, init_local
import test_torch_mesh_cp as t
rank, world, store, shape, out = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
init_local("gloo", world, rank, store, timeout_s=60)
try:
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(
        tuple(int(x) for x in shape.split("x"))),
        mesh_dim_names=("data", "model"))
    torch.save(t._worker(shape, mesh, rank), f"{out}.{rank}")
finally:
    destroy()
"""


def _start(shape: str):
    world = int(np.prod([int(x) for x in shape.split("x")]))
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "res")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SPAWN, str(r), str(world),
         os.path.join(tmp, "store"), shape, out, str(ROOT / "src"),
         str(ROOT / "tests")], env=env, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return procs, out


@functools.lru_cache(maxsize=None)
def _spawned() -> dict:
    """Every rank's results on ``(1, 2)`` and on ``(2, 2)``: the six
    processes run at once."""
    started = {shape: _start(shape) for shape in ("1x2", "2x2")}
    try:
        errs = {shape: [p.communicate(timeout=SPAWN_TIMEOUT_S)[1]
                        for p in procs]
                for shape, (procs, _) in started.items()}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = {}
    for shape, (procs, path) in started.items():
        for p, err in zip(procs, errs[shape]):
            assert p.returncode == 0, err[-4000:]
        out[shape] = [torch.load(f"{path}.{r}", weights_only=False)
                      for r in range(len(procs))]
    return out


def _assert_same(got, want):
    assert len(got["logits"]) == len(want["logits"])
    for a, b in zip(got["logits"], want["logits"]):
        assert torch.equal(a, b)
    assert got["ops"] == want["ops"]
    assert set(got["cache"]) == set(want["cache"])
    for key, leaf in want["cache"].items():
        assert torch.equal(got["cache"][key], leaf), key
    for key in ("census", "tokens", "reused", "request_ops"):
        if key in want:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# (a) K1's split launch, plain version
# ---------------------------------------------------------------------------

def _split_launch(a, w, scalars, blocks: int, **regs):
    """Pass 1 on each block of rows, the cells max-reduced, pass 2 on each
    block: (y, ops) as the ranks would return them together."""
    parts = [k1_ref.trq_group_mvm_psums_ref(x, w)
             for x in torch.chunk(a, blocks)]
    cells = torch.stack([st[1:].view(torch.int32) for _, st in parts])
    assert len(set(cells[:, 0].tolist())) == blocks    # the blocks' own
    top = torch.amax(cells, 0)
    outs = []
    for part, st in parts:
        st[1:].view(torch.int32).copy_(top)
        outs.append(k1_ref.trq_group_mvm_quantize_ref(
            part, st, scalars, a.shape[1], **regs))
    return (torch.cat([y for y, _ in outs]),
            sum(int(o) for _, o in outs))


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("m,k,n", [(16, 300, 130), (64, 512, 72),
                                   (8, 128, 256)])
def test_k1_split_launch_equals_one_call(m, k, n, blocks):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    a[blocks - 1] *= 4.0          # one block's maximum stands out
    w = torch.from_numpy(rng.normal(0, 0.1, (k, n)).astype(np.float32))
    regs = dict(n_r1=2, n_r2=6, m=1, nu=1, mode="twin")
    scalars = torch.tensor([1.0, 0.0, 0.0371], dtype=torch.float32)
    y, ops = _split_launch(a, w, scalars, blocks, **regs)
    y1, ops1 = k1_ops.trq_group_mvm_2d(a, w, scalars, auto_range=True,
                                       **regs)
    assert torch.equal(y, y1) and ops == int(ops1)
    # each block fitted alone would not be
    y_own = torch.cat([k1_ops.trq_group_mvm_2d(
        x, w, scalars, auto_range=True, **regs)[0]
        for x in torch.chunk(a, blocks)])
    assert not torch.equal(y_own, y1)


def test_k1_split_launch_matches_reference_kernel():
    """Integer inputs, a power-of-two grid: every partial sum is exact, so
    the split launch equals the reference's auto-ranged kernel (interpret
    mode) bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.trq import make_params as jmake
    from repro.pim.backend import pallas_backend as jpallas
    rng = np.random.default_rng(5)
    a = rng.integers(-8, 9, (8, 300)).astype(np.float32)
    a[5] *= 3
    w = rng.integers(-8, 9, (300, 72)).astype(np.float32)
    regs = dict(n_r1=2, n_r2=6, m=1)
    yj, oj = jpallas(jnp.asarray(a), jnp.asarray(w),
                     jmake(delta_r1=1.0, signed=True, **regs),
                     auto_range=True, interpret=True, a_scale=0.5,
                     w_scale=2.0)
    scalars = torch.tensor([1.0, 0.0, 0.5 * 2.0], dtype=torch.float32)
    for blocks in (2, 4):
        y, ops = _split_launch(torch.from_numpy(a), torch.from_numpy(w),
                               scalars, blocks, nu=1, mode="twin", **regs)
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
        assert ops == float(oj)


# ---------------------------------------------------------------------------
# (b) attention on a q block at its offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [2, 4])
def test_q_block_attention_matches_context_parallel_reference(blocks):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(6)
    b, s, kv, g, hd = 2, 64, 2, 3, 16
    q = rng.normal(0, 1, (b, s, kv, g, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    want_c = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 16, 16,
        context_parallel=True))
    want_f = np.asarray(jattn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    per = s // blocks
    for i in range(blocks):
        rows = slice(i * per, (i + 1) * per)
        qb = torch.from_numpy(q[:, rows])
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        got_c = tattn.chunked_attention(qb, kt, vt, True, 16, 16,
                                        q_off=rows.start)
        got_f = tattn.full_attention(qb, kt, vt, True, q_off=rows.start)
        np.testing.assert_allclose(got_c.numpy(), want_c[:, rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_f.numpy(), want_f[:, rows],
                                   rtol=1e-5, atol=1e-5)
    # a continued prefill: the block after a cache of 8 rows, per-row
    # offsets as a (B,) tensor against the reference's full_attention
    idx = np.array([8, 8], np.int32)
    want = np.asarray(jattn.full_attention(
        jnp.asarray(q[:, 8:40]), jnp.asarray(k[:, :40]),
        jnp.asarray(v[:, :40]), True, q_off=jnp.asarray(idx)))
    half = 16
    for i in range(2):
        got = tattn.full_attention(
            torch.from_numpy(q[:, 8 + i * half:8 + (i + 1) * half]),
            torch.from_numpy(k[:, :40]), torch.from_numpy(v[:, :40]), True,
            q_off=torch.from_numpy(idx) + i * half)
        np.testing.assert_allclose(got.numpy(),
                                   want[:, i * half:(i + 1) * half],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (c)-(e) spawned ranks
# ---------------------------------------------------------------------------

def test_seq_share_follows_the_layout_and_divisibility():
    from repro_torch.dist.sharding import AbstractMesh

    class Mesh(AbstractMesh):
        def get_local_rank(self, name):
            return 1
    mesh = Mesh((1, 4), ("data", "model"))
    llama = get_config("llama3.2-3b", smoke=True)
    assert group.seq_share(mesh, llama, 32) == slice(8, 16)
    assert group.seq_share(mesh, llama, 30) is None          # indivisible
    assert group.seq_share(mesh, llama, 1) is None           # decode
    assert group.seq_share(None, llama, 32) is None
    granite = get_config("granite-moe-3b-a800m", smoke=True)
    assert granite.parallelism == "tp"
    assert group.seq_share(mesh, granite, 32) is None


def test_model_refuses_a_split_it_has_no_block_for():
    """The Runtime marks the sequence split only where the model axis
    divides it; a forward marked split on rows it does not divide raises
    rather than running with no block of its own."""
    from repro_torch.dist.sharding import AbstractMesh, use_mesh
    from repro_torch.models.layers import PimContext

    class Mesh(AbstractMesh):
        def get_local_rank(self, name):
            return 0
    cfg = get_config("llama3.2-3b", smoke=True).replace(pim_backend="exact")
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu")
    ctx = PimContext(cfg, "exact", device="cpu")
    toks = torch.zeros((1, 15), dtype=torch.int64)
    with use_mesh(Mesh((1, 2), ("data", "model"))), \
            group.split_rows(("model",)):
        assert group.seq_is_split()
        with pytest.raises(ValueError, match="no block"):
            rt.model(toks, ctx)


@pytest.mark.parametrize("backend", ["pallas", "bit_exact"])
def test_two_ranks_seq_split_serve_bitwise(backend):
    ranks = _spawned()["1x2"]
    want = ranks[0][backend, True]
    assert want["reused"][1] > 0                  # the continued prefill
    for res in ranks:
        _assert_same(res[backend, False], want)


def test_two_ranks_seq_split_vlm_prefill_bitwise():
    ranks = _spawned()["1x2"]
    want = ranks[0]["vlm", True]
    assert want["rows"] % 2 == 0 and want["ops"][0] > 0
    for res in ranks:
        _assert_same(res["vlm", False], want)


def _assert_train_matches(shape):
    """The split step's loss and A/D ops one process's bitwise, every
    parameter at ``test_torch_mesh``'s 1e-5 bar (a weight gradient sums
    the rows in another order), and each rank's backward on another
    thread than its forward."""
    ranks = _spawned()[shape]
    want = ranks[0]["train", True]
    for res in ranks:
        assert res["backward_threads"] == TRAIN_STEPS
        got = res["train", False]
        assert got["loss"] == want["loss"]
        assert got["ad_ops"] == want["ad_ops"]
        for name, p in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       p.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_two_ranks_seq_split_train_step():
    """The sequence split over 'model', the remat recompute on autograd's
    thread (:func:`_backward_on_another_thread`)."""
    _assert_train_matches("1x2")


def test_four_ranks_split_train_step():
    """Batch and sequence split, the remat recompute on another thread."""
    _assert_train_matches("2x2")


def test_four_ranks_serve_bitwise():
    ranks = _spawned()["2x2"]
    want = ranks[0]["pallas", True]
    for res in ranks:
        _assert_same(res["pallas", False], want)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_ranks_bring_their_own_maxima_sums_and_losses(shape):
    """What each rank brings to the four reductions is not the whole's: the
    ranks' maxima, cells and token means differ, and each rank's A/D
    count is below the ranks' sum; so a rank-local reduction would change
    the bitwise results above."""
    ranks = _spawned()[shape]
    seen = [r["seen"] for r in ranks]
    kinds = [k for k, _ in seen[0]]
    assert all([k for k, _ in s] == kinds for s in seen)
    want = {"max", "cells", "sum", "loss"}
    assert want <= set(kinds)
    for kind in want - {"sum"}:
        calls = [i for i, k in enumerate(kinds) if k == kind]
        assert any(not torch.equal(seen[0][i][1], seen[r][i][1])
                   for i in calls for r in range(1, len(seen))), kind
    counts = [[float(s[i][1]) for s in seen]
              for i, kind in enumerate(kinds) if kind == "sum"]
    counts = [c for c in counts if sum(c)]       # a model without MoE: aux 0
    assert counts and all(0 <= v < sum(c) for c in counts for v in c)


@pytest.mark.parametrize("entry,argtypes", [
    ("trq_group_mvm_psums_launch", "_PSUMS_ARGTYPES"),
    ("trq_group_mvm_quantize_launch", "_QUANTIZE_ARGTYPES")])
def test_split_entries_bind_their_prototypes(entry, argtypes):
    """The split launch's two C entries, held to their ctypes argument
    lists (the GPU compiler is not here to check them)."""
    import ctypes
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.trq_group_mvm import kernel
    src = (build.CSRC / "trq_group_mvm.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
    assert m, entry
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert list(getattr(kernel, argtypes)) == want
    assert callable(kernel._psums_lib) and callable(kernel._quantize_lib)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_rows_keep_their_bits_in_a_split(card):
    """On the card: K1's split launch in 2 and 4 blocks equals one call,
    and rmsnorm's rows equal a call on fewer rows (a split sequence's
    rank holds fewer)."""
    from repro_torch.kernels.trq_group_mvm import kernel
    from repro_torch.models.layers import rmsnorm
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    a = torch.randn(64, 3072, generator=gen, device=card)
    a[-1] *= 4.0
    w = (torch.randn(3072, 1024, generator=gen, device=card) * 0.02).to(
        torch.bfloat16)
    regs = dict(n_r1=6, n_r2=6, m=4, nu=1, mode="twin")
    scalars = torch.tensor([1.0, 0.0, 0.01], device=card)
    y1, o1 = kernel.trq_group_mvm_cuda(a, w, scalars, auto_range=True, **regs)
    for blocks in (2, 4):
        parts = [kernel.trq_group_mvm_psums_cuda(x.contiguous(), w)
                 for x in a.chunk(blocks)]
        top = torch.amax(torch.stack([st[1:].view(torch.int32)
                                      for _, st in parts]), 0)
        ys, ops = [], 0
        for part, st in parts:
            st[1:].view(torch.int32).copy_(top)
            y, o = kernel.trq_group_mvm_quantize_cuda(part, st, scalars, 3072,
                                                      **regs)
            ys.append(y)
            ops += int(o)
        assert torch.equal(torch.cat(ys), y1) and ops == int(o1)
    for d in (3072, 4096, 8192):          # the dense decoders' widths
        for s in (8, 16, 32, 64, 320):
            x = (torch.randn(1, s, d, generator=gen, device=card) * 3).to(
                torch.bfloat16)
            sc = torch.rand(d, generator=gen, device=card)
            half = torch.cat([rmsnorm(sc, x[:, :s // 2].contiguous()),
                              rmsnorm(sc, x[:, s // 2:].contiguous())], 1)
            assert torch.equal(half, rmsnorm(sc, x)), (d, s)

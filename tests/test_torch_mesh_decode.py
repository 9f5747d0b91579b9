"""The reference's decode layout on the model axis: a meshed decode step
keeps and attends only its share of the KV cache, and the MoE Switch loss
is the whole batch's under a batch split.

(a) KV-head branch (the KV heads divide 'model'): two gloo ranks on
    ``(1, 2)`` and four on ``(2, 2)``.  llama, granite, jamba and whisper
    smoke on ``pallas`` and on ``bit_exact`` prefill four rows, decode a
    step through ``Runtime.decode`` (a whole cache in and out) and
    through ``decode(kv_share=True)`` (the K/V share in, this rank's rows
    and heads out), and run the paged engine over three requests.  Logits,
    caches, tokens and the A/D counts (per call and per request) are
    bitwise the mesh-less run's (``mesh=None``, in one of the ranks).
(b) The share decode gathers no cache: its all-gathers are exactly one a
    cross- or self-attention layer (the output's heads) plus, with a data
    split, the logits and the slot-resident leaves; on a model-only mesh
    it issues nothing else; ``DTensor.full_tensor`` is not called, in it
    or in any engine decode step.  Each rank's pools hold 1/m of the
    mesh-less pools' bytes.
(c) Head-dim branch (two KV heads on a 4-wide axis, hd 16): four ranks on
    ``(1, 4)``.  The attention output (``wo``'s input) of every layer of
    a decode step, fed the mesh-less step's inputs, is within f32
    ``rtol = atol = 1e-6`` of the mesh-less one (the scores are partial
    sums over the ranks: another order, not bitwise); whole-model greedy
    tokens and A/D ops equal the mesh-less run's on the named seeds
    (``SEEDS``, whose inputs cross no quantizer step), and the caches are
    bitwise (the new keys and values come from whole projections).
(d) The Switch loss on ``(2, 1)`` and ``(2, 2)``: granite and jamba smoke
    on ``fake_quant`` in f32.  The forward's Switch loss and the compared
    train step's loss are within ``rtol = 1e-6`` of the mesh-less ones on
    every rank, the parameters after the step within the mesh tests' 1e-5
    bar, and the A/D ops equal.  As in ``test_torch_mesh``, the compared
    step is the fourth, from the state of three mesh-less steps.

Two spawns run at once: two ranks host ``(1, 2)`` and ``(2, 1)``, four
host ``(2, 2)`` and ``(1, 4)``; every process on one intra-op thread,
each spawn under its own time limit.
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
from repro_torch.dist import group  # noqa: E402
from repro_torch.models.registry import (get_config, init,  # noqa: E402
                                         model_module)
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 150
ARCHS = ("llama3.2-3b", "granite-moe-3b-a800m", "jamba-v0.1-52b",
         "whisper-medium")
BACKENDS = ("pallas", "bit_exact")
MOE_ARCHS = ("granite-moe-3b-a800m", "jamba-v0.1-52b")
MAX_LEN = 32
FRAMES = 8                        # whisper's frames a request
SEEDS = (3, 4)                    # (c): inputs of the head-dim branch
TC = dict(total_steps=20, warmup_steps=2, checkpoint_every=0)
TRAIN_STEPS = 4


def _cfg(arch, backend, **kw):
    return get_config(arch, smoke=True).replace(pim_backend=backend, **kw)


def _frames(cfg, rng):
    """An encoder-decoder's ``extra_inputs``: seeded frames a prefill."""
    def extra_inputs(b, s):
        if s == 1 or not cfg.encoder_layers:
            return {}
        return {"embeds": rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)}
    return extra_inputs


class _Collectives:
    """The c10d operations issued in its extent by name, those inside a
    parameter's gather (``dist.sharding.full``, before each layer) as
    ``"param"``, and the calls of ``DTensor.full_tensor``."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.dist import sharding
        seen = self.ops = []
        self.full = 0
        depth = [0]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace in ("c10d", "_c10d_functional"):
                    seen.append("param" if depth[0] else
                                func.__name__.split(".")[0])
                return func(*args, **(kwargs or {}))
        self._param = sharding.full

        def full(t):
            depth[0] += 1
            try:
                return self._param(t)
            finally:
                depth[0] -= 1
        sharding.full = full
        self._orig = DTensor.full_tensor

        def full_tensor(t, *a, **k):
            self.full += 1
            return self._orig(t, *a, **k)
        DTensor.full_tensor = full_tensor
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        from repro_torch.dist import sharding
        self._mode.__exit__(*exc)
        DTensor.full_tensor = self._orig
        sharding.full = self._param

    def count(self, name):
        return sum(op == name for op in self.ops)

    def others(self):
        """The operations other than ``dist.all_gather``/``all_reduce``,
        a parameter's gather and a wait on one."""
        return [op for op in self.ops if op not in (
            "allgather_", "allreduce_", "param", "wait_tensor")]


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

def _serve(arch, backend, mesh=None, seed=3, **kw):
    """A 4-row prefill, a decode through ``Runtime.decode``, the same
    decode on the K/V share (on a mesh) and the engine over three
    requests (its decode batch is 4 rows)."""
    cfg = _cfg(arch, backend, **kw)
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         mesh=mesh)
    rng = np.random.default_rng(seed)
    extra = _frames(cfg, rng)
    toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    (last, cache), rep = rt.prefill(toks, extra(4, 8), max_len=MAX_LEN)
    nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
    (dec, whole), rep_d = rt.decode(nxt, cache)
    out = {"logits": (last, dec), "ops": (int(rep.ad_ops), int(rep_d.ad_ops)),
           "cache": dict(whole)}
    share = group.head_share(mesh, cfg)
    if mesh is not None:
        paged = model_module(cfg).paged_keys(cfg)
        cut = {k: share.keys(v) if share and k in paged else v
               for k, v in cache.items()}
        with _Collectives() as coll:
            (dec_s, part), rep_s = rt.decode(nxt, cut, kv_share=True)
        out.update(share_logits=dec_s, share_ops=int(rep_s.ad_ops),
                   share_cache={k: v for k, v in part.items() if k in paged},
                   rows=rt.rows(4), gathers=coll.count("allgather_"),
                   others=coll.others(), full_tensor=coll.full,
                   reduces=coll.count("allreduce_"),
                   params=coll.count("param"))
    eng = ServeEngine(rt, max_batch=4, max_len=MAX_LEN * 2,
                      extra_inputs=extra)
    steps = []
    gather, writeback = eng._decode_cache, eng._writeback

    def counted_gather():       # a decode step: its pages gathered ...
        eng.coll = _Collectives().__enter__()
        return gather()

    def counted_writeback(*a):  # ... through its blocks written back
        writeback(*a)
        eng.coll.__exit__(None, None, None)
        steps.append((eng.coll.count("allgather_"), eng.coll.full))
    eng._decode_cache, eng._writeback = counted_gather, counted_writeback
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=3)
            for n in (5, 9, 12)]        # slots 0-2: rows of both data ranks
    eng.run()
    out.update(tokens=[r.generated for r in reqs],
               request_ops=[r.ad_ops for r in reqs], steps=steps,
               pool_bytes=sum(p.to_local().nbytes if hasattr(p, "to_local")
                              else p.nbytes for p in eng.kv.pools.values()))
    return out


def _attention_io(mesh=None, seed=SEEDS[0]):
    """Feed every attention layer of a decode step the mesh-less step's
    inputs (captured there) and return each one's output before ``wo``
    (f32 compute, ``pallas``)."""
    cfg = _cfg("llama3.2-3b", "pallas", dtype="float32")
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    (last, cache), _ = rt.prefill(toks, max_len=MAX_LEN)
    nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
    inputs, outs = [], []
    hooks = []
    for layer in rt.model.layers:
        hooks.append(layer.attn.register_forward_pre_hook(
            lambda m, a, k: inputs.append((a, k)), with_kwargs=True))
        hooks.append(layer.attn.wo.register_forward_pre_hook(
            lambda m, a: outs.append(a[0])))
    rt.decode(nxt, cache)
    for h in hooks:
        h.remove()
    if mesh is None:
        return outs
    rt_m = runtime.compile(cfg, init(cfg, seed=0, device="cpu"),
                           device="cpu", mesh=mesh)
    share = group.head_share(mesh, cfg)
    got = []
    for layer, (args, kw) in zip(rt_m.model.layers, inputs):
        h = layer.attn.wo.register_forward_pre_hook(
            lambda m, a: got.append(a[0]))
        lc = dict(kw["cache"])
        lc.update(k=share.keys(lc["k"]), v=share.keys(lc["v"]))
        with torch.no_grad(), rt_m._ambient(), group.split_heads(share):
            layer.attn(args[0], rt_m._ctx(), args[2], cache=lc)
        h.remove()
    return got


def _train(arch, mesh=None):
    """Steps 0-2 mesh-less, step 3 on ``mesh`` (or mesh-less too): the
    loss, the forward's Switch loss before the step, A/D ops, the
    parameters."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist.sharding import assign
    cfg = _cfg(arch, "fake_quant", dtype="float32")
    tc = TrainConfig(**TC)
    stream = TokenStream(cfg.vocab_size, 16, 4)
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cpu"), device="cpu",
                         plan=None, tc=tc)
    opt = rt.opt_init()
    for i in range(TRAIN_STEPS - 1):
        (_, opt, m), _ = rt.train_step(rt.params, opt, stream.batch_at(
            i, device="cpu"), i)
    batch = stream.batch_at(TRAIN_STEPS - 1, device="cpu")
    if mesh is not None:
        state = {n: p.detach().clone() for n, p in rt.params.items()}
        rt = runtime.compile(cfg, state, device="cpu", plan=None, tc=tc,
                             mesh=mesh)
        step, opt_init, _, _ = rt.train_setup()
        placed = opt_init()
        for part in ("m", "v"):
            for path, leaf in placed[part].items():
                assign(leaf, opt[part][path])
        placed["step"] = opt["step"]
        opt = placed
    else:
        def step(p, o, b, i):
            return rt.train_step(p, o, b, i)[0]
    (_, _, aux), _ = rt.apply({"tokens": batch["tokens"]})
    _, opt, m = step(rt.params, opt, batch, TRAIN_STEPS - 1)
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
              .detach() for n, p in rt.params.items()}
    return {"loss": float(m["loss"]), "aux": float(aux),
            "ad_ops": int(m["ad_ops"]), "params": params}


def _refs(world: int) -> list:
    """The mesh-less runs a spawn of ``world`` ranks compares against:
    (key, function, arguments)."""
    out = [(("ref", arch, be), _serve, (arch, be))
           for arch in ARCHS for be in BACKENDS]
    out += [(("ref", "train", arch), _train, (arch,)) for arch in MOE_ARCHS]
    if world == 4:
        out.append((("ref", "attn"), _attention_io, ()))
        out += [(("ref", "hd", seed), _serve, ("llama3.2-3b", "pallas",
                                               None, seed)) for seed in SEEDS]
    return out


def _worker(world: int, rank: int) -> dict:
    """Everything a rank returns: two ranks host ``(1, 2)`` and ``(2,
    1)``, four ``(2, 2)`` and ``(1, 4)``; the mesh-less runs are dealt out
    over the ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    shapes = ((1, 2), (2, 1)) if world == 2 else ((2, 2), (1, 4))
    meshes = {s: DeviceMesh("cpu", torch.arange(world).reshape(s),
                            mesh_dim_names=("data", "model")) for s in shapes}
    res = {}
    for shape, mesh in meshes.items():
        name = "x".join(map(str, shape))
        if shape[1] > 1 and shape != (1, 4):
            for arch in ARCHS:
                for be in BACKENDS:
                    res[name, arch, be] = _serve(arch, be, mesh)
        if shape == (1, 4):
            res[name, "attn"] = _attention_io(mesh)
            for seed in SEEDS:
                res[name, "hd", seed] = _serve("llama3.2-3b", "pallas", mesh,
                                               seed=seed)
        if shape[0] > 1:
            for arch in MOE_ARCHS:
                res[name, "train", arch] = _train(arch, mesh)
    for key, fn, args in _refs(world)[rank::world]:
        res[key] = fn(*args)
    return res


_SPAWN = """
import sys
sys.path[:0] = [sys.argv[5], sys.argv[6]]
import torch
torch.set_num_threads(1)
from repro_torch.dist.group import destroy, init_local
import test_torch_mesh_decode as t
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
init_local("gloo", world, rank, store, timeout_s=60)
try:
    torch.save(t._worker(world, rank), f"{out}.{rank}")
finally:
    destroy()
"""


@functools.lru_cache(maxsize=None)
def _spawned() -> dict:
    """{world: every rank's results}, the two spawns at once."""
    started = {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for world in (2, 4):
        tmp = tempfile.mkdtemp()
        out = os.path.join(tmp, "res")
        started[world] = ([subprocess.Popen(
            [sys.executable, "-c", _SPAWN, str(r), str(world),
             os.path.join(tmp, "store"), out, str(ROOT / "src"),
             str(ROOT / "tests")], env=env, stderr=subprocess.PIPE,
            text=True) for r in range(world)], out)
    try:
        errs = {w: [p.communicate(timeout=SPAWN_TIMEOUT_S)[1] for p in procs]
                for w, (procs, _) in started.items()}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    res = {}
    for world, (procs, path) in started.items():
        for p, err in zip(procs, errs[world]):
            assert p.returncode == 0, err[-4000:]
        res[world] = [torch.load(f"{path}.{r}", weights_only=False)
                      for r in range(world)]
    return res


def _ranks(shape: str) -> tuple:
    """(every rank's results on ``shape``, the mesh-less ones)."""
    ranks = _spawned()[2 if shape in ("1x2", "2x1") else 4]
    ref = {}
    for res in ranks:
        ref.update({k: v for k, v in res.items() if k[0] == "ref"})
    return ranks, ref


def _sites(cfg) -> int:
    """Attention layers that read a cache at decode (self and cross)."""
    n = sum(cfg.layer_kind(i % cfg.period)[0] == "attn"
            for i in range(cfg.n_layers)) if not cfg.encoder_layers \
        else 2 * cfg.n_layers
    return n


# ---------------------------------------------------------------------------
# (a) the KV-head branch, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_kv_head_share_decodes_bitwise(shape, arch, backend):
    ranks, ref = _ranks(shape)
    want = ref["ref", arch, backend]
    cfg = get_config(arch, smoke=True)
    assert cfg.n_kv_heads % int(shape.split("x")[1]) == 0
    for res in ranks:
        got = res[shape, arch, backend]
        for a, b in zip(got["logits"], want["logits"]):
            assert torch.equal(a, b)
        assert torch.equal(got["share_logits"], want["logits"][1])
        assert got["ops"] == want["ops"]
        assert got["share_ops"] == want["ops"][1]
        assert set(got["cache"]) == set(want["cache"])
        for key, leaf in want["cache"].items():
            assert torch.equal(got["cache"][key], leaf), key
        assert got["tokens"] == want["tokens"]
        assert got["request_ops"] == want["request_ops"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_share_decode_returns_this_ranks_rows_and_heads(shape, arch):
    """The K/V leaves of a ``kv_share`` decode are the mesh-less new
    cache's rows of this rank (``Runtime.rows``) and its heads, in head
    order: rank r of m holds KV heads [r KV/m, (r+1) KV/m)."""
    ranks, ref = _ranks(shape)
    want = ref["ref", arch, "pallas"]["cache"]
    m = int(shape.split("x")[1])
    for r, res in enumerate(ranks):
        got = res[shape, arch, "pallas"]
        rows = got["rows"] or slice(None)
        for key, leaf in got["share_cache"].items():
            kv = want[key].shape[-2] // m
            i = r % m
            assert torch.equal(leaf, want[key][:, rows, :,
                                               i * kv:(i + 1) * kv]), key


# ---------------------------------------------------------------------------
# (b) no cache gather; the pools' bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,arch", [
    (s, a) for s in ("1x2", "2x2") for a in ARCHS] + [("1x4", ARCHS[0])])
def test_share_decode_gathers_no_cache(shape, arch):
    """One all-gather an attention site (its output's heads); with a data
    split, one for the logits and one a slot-resident leaf; on a
    model-only mesh no all-reduce (a head-dim share: one a site); every
    other collective gathers a parameter (DTensor's, before each layer).
    No ``full_tensor``, in the share decode or in any engine decode step
    from its pages' gather to its write-back."""
    ranks, ref = _ranks(shape)
    key = (shape, "hd", SEEDS[0]) if shape == "1x4" else \
        (shape, arch, "pallas")
    cfg = get_config(arch, smoke=True)
    paged = model_module(cfg).paged_keys(cfg)
    hd_branch = cfg.n_kv_heads % int(shape.split("x")[1]) != 0
    for res in ranks:
        got = res[key]
        state = len(got["cache"]) - len(paged)
        data = 1 if shape.startswith("2") else 0
        assert got["gathers"] == _sites(cfg) + data * (1 + state)
        assert got["full_tensor"] == 0
        if not data:
            assert got["reduces"] == (_sites(cfg) if hd_branch else 0)
        assert got["others"] == [] and got["params"] > 0
        assert got["steps"] and all(full == 0 for _, full in got["steps"])
        assert all(n == got["gathers"] for n, _ in got["steps"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_pools_hold_one_share_of_the_bytes(shape, arch):
    ranks, ref = _ranks(shape)
    whole = ref["ref", arch, "pallas"]["pool_bytes"]
    m = int(shape.split("x")[1])
    assert whole > 0
    for res in ranks:
        assert res[shape, arch, "pallas"]["pool_bytes"] * m == whole


# ---------------------------------------------------------------------------
# (c) the head-dim branch
# ---------------------------------------------------------------------------

def test_head_dim_share_attention_within_f32_bar():
    ranks, ref = _ranks("1x4")
    want = ref["ref", "attn"]
    cfg = get_config("llama3.2-3b", smoke=True)
    assert cfg.n_kv_heads % 4 and cfg.hd % 4 == 0
    assert len(want) == cfg.n_layers
    for res in ranks:
        got = res["1x4", "attn"]
        assert len(got) == len(want)
        for layer, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"layer {layer}")


@pytest.mark.parametrize("seed", SEEDS)
def test_head_dim_share_tokens_and_ops_on_named_seeds(seed):
    ranks, ref = _ranks("1x4")
    want = ref["ref", "hd", seed]
    for res in ranks:
        got = res["1x4", "hd", seed]
        assert got["tokens"] == want["tokens"]
        assert got["request_ops"] == want["request_ops"]
        assert got["ops"] == want["ops"]
        for key, leaf in want["cache"].items():
            assert torch.equal(got["cache"][key], leaf), key
        assert torch.equal(torch.argmax(got["share_logits"], -1),
                           torch.argmax(want["logits"][1], -1))


# ---------------------------------------------------------------------------
# (d) the whole-batch Switch loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_switch_loss_is_the_whole_batchs(shape, arch):
    ranks, ref = _ranks(shape)
    want = ref["ref", "train", arch]
    assert want["aux"] > 0
    for res in ranks:
        got = res[shape, "train", arch]
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert got["ad_ops"] == want["ad_ops"]
        for name, p in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       p.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_head_share_follows_the_reference_rule():
    """KV heads when they divide 'model', else the head dim, else none;
    every rank decides alike."""
    from repro_torch.dist.sharding import AbstractMesh

    class Mesh(AbstractMesh):
        def get_local_rank(self, name):
            return 1
    cfg = get_config("llama3.2-3b", smoke=True)      # KV 2, hd 16
    assert group.head_share(None, cfg) is None
    assert group.head_share(Mesh((2, 1), ("data", "model")), cfg) is None
    kv = group.head_share(Mesh((1, 2), ("data", "model")), cfg)
    assert kv.kv and (kv.ranks, kv.index) == (2, 1)
    hd = group.head_share(Mesh((1, 4), ("data", "model")), cfg)
    assert not hd.kv and hd.ranks == 4
    assert group.head_share(Mesh((1, 32), ("data", "model")), cfg) is None
    t = torch.arange(2 * 16).reshape(1, 1, 2, 16)
    assert torch.equal(kv.keys(t), t[:, :, 1:])
    assert torch.equal(hd.keys(t), t[..., 4:8])


# ---------------------------------------------------------------------------
# the decode products on a share of the heads (kernels.decode_attn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kv,g,hd,sk", [
    (4, 8, 3, 16, 32), (2, 2, 1, 8, 16), (3, 4, 2, 8, 16)])
def test_products_by_head_equal_the_batched_call(b, kv, g, hd, sk):
    """The two halves of one-row attention (``kernels.decode_attn``'s
    plain versions, which a CPU tensor takes) on each half of the KV heads
    give those heads of the whole call, bitwise, with the probabilities
    rounded to the cache's dtype (self-attention) or not (cross)."""
    from repro_torch.kernels.decode_attn import attn_scores, attn_values
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, 1, kv, g, hd), (b, sk, kv, hd),
                                   (b, sk, kv, hd)))
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    n = torch.from_numpy(rng.integers(1, sk + 1, b).astype(np.int32))
    want_s = attn_scores(q, k)
    assert want_s.shape == (b, kv, g, 1, sk)
    for lens, round_a in ((n, True), (None, False)):
        want_o = attn_values(want_s, v, lens, round_a)
        assert want_o.shape == (b, 1, kv, g, hd)
        h = kv // 2
        for i in range(2):
            heads = slice(i * h, (i + 1) * h)
            s = attn_scores(q[:, :, heads], k[:, :, heads])
            assert torch.equal(s, want_s[:, heads])
            assert torch.equal(attn_values(s, v[:, :, heads], lens, round_a),
                               want_o[:, :, heads])


@pytest.mark.parametrize("branch,m", [("kv", 2), ("hd", 2), ("hd", 4)])
def test_share_attention_matches_the_reference(branch, m):
    """A decode step's self- and cross-attention on each rank's share,
    put together as the ranks do (the head-dim branch's partial scores
    summed in rank order before the softmax, each share's output in head
    order), against ``repro.models.attention``'s ``decode_attention`` and
    ``full_attention`` on the whole heads, in f32 at rtol = atol = 1e-6
    (the bar the head-dim branch is held to against one device)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import attention as jattn
    from repro_torch.kernels.decode_attn import attn_scores
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(11)
    b, s, kv, g, hd = 3, 24, 2, 3, 16
    q = rng.standard_normal((b, 1, kv, g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    n = np.array([5, 24, 17], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n)))
    want_x = np.asarray(jattn.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False))
    qt, kt, vt, nt = map(torch.from_numpy, (q, k, v, n))
    scale = hd ** -0.5
    if branch == "kv":
        h = kv // m
        cut = [(slice(None),) * 2 + (slice(i * h, (i + 1) * h),)
               for i in range(m)]
        got = torch.cat([tattn.decode_attention(
            qt[c], kt[c], vt[c], nt, scale) for c in cut], 2)
        got_x = torch.cat([tattn.cross_decode_attention(
            qt[c], kt[c], vt[c], scale) for c in cut], 2)
    else:
        w = hd // m
        cut = [(Ellipsis, slice(i * w, (i + 1) * w)) for i in range(m)]
        total = total_x = 0
        for c in cut:                          # the all-reduce, rank order
            total = total + attn_scores(qt[c] * scale, kt[c])
            total_x = total_x + attn_scores(qt[c] * scale, kt[c])
        got = torch.cat([tattn.decode_attention(
            qt[c], kt[c], vt[c], nt, scale, lambda _: total) for c in cut],
            -1)
        got_x = torch.cat([tattn.cross_decode_attention(
            qt[c], kt[c], vt[c], scale, lambda _: total_x) for c in cut], -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ranks", [2, 4])
def test_switch_loss_of_rank_blocks_matches_the_reference(monkeypatch,
                                                         ranks):
    """granite's MoE layer on a batch cut into ``ranks`` row blocks, each
    block's Switch loss taken as a rank takes it (its sums added to the
    other blocks', in rank order, by the reduction ``global_sum`` stands
    for): every block's loss is ``repro.models.moe``'s whole-batch one at
    rtol 1e-6."""
    jax = pytest.importorskip("jax")
    from repro.models import moe as jmoe
    from repro.models.registry import get_config as jget_config
    from repro_torch.convert import _flatten, _tensor
    from repro_torch.models import moe
    f32 = dict(remat="none", dtype="float32")
    arch = "granite-moe-3b-a800m"
    jcfg = jget_config(arch, smoke=True).replace(**f32)
    tcfg = get_config(arch, smoke=True).replace(**f32)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    mod = moe.MoE(tcfg, torch.float32, device="meta")
    mod.load_state_dict({path: _tensor(leaf) for path, leaf in _flatten(
        jax.tree.map(np.asarray, p))}, assign=True)
    x = np.random.default_rng(5).standard_normal(
        (4, 8, jcfg.d_model)).astype(np.float32)
    _, want = jmoe.apply_moe(p, jax.numpy.asarray(x), jcfg)
    blocks = np.split(x, ranks)
    sums = []
    monkeypatch.setattr(group, "rows_split", lambda: True)
    monkeypatch.setattr(group, "global_sum",
                        lambda t: sums.append(t) or t)
    with torch.no_grad():
        for blk in blocks:                       # each rank's own sums
            mod(torch.from_numpy(blk))
    total = functools.reduce(torch.add, sums)
    monkeypatch.setattr(group, "global_sum", lambda t: total)
    with torch.no_grad():
        for blk in blocks:
            _, aux = mod(torch.from_numpy(blk))
            np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode_attn kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_decode_attention_on_a_share_of_the_heads_is_bitwise(card):
    """On the card: ``decode_attention`` and ``cross_decode_attention`` on
    a share of the KV heads equal those heads of the whole call, at
    llama's, whisper's and deepseek's decode shapes (the decode_attn
    kernel sums each head alike whatever the heads beside it)."""
    from repro_torch.models.attention import (cross_decode_attention,
                                              decode_attention)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    for b, kv, g, hd, s in ((4, 8, 3, 128, 256), (4, 16, 1, 64, 1504),
                            (4, 32, 1, 128, 256)):
        q = torch.randn(b, 1, kv, g, hd, generator=gen, device=card)
        kc, vc = (torch.randn(b, s, kv, hd, generator=gen,
                              device=card).to(torch.bfloat16)
                  for _ in range(2))
        n = torch.full((b,), s - 3, dtype=torch.int32, device=card)
        whole = decode_attention(q, kc, vc, n)
        whole_x = cross_decode_attention(q, kc, vc)
        for m in (2, 4):
            h = kv // m
            for i in range(m):
                c = (slice(None),) * 2 + (slice(i * h, (i + 1) * h),)
                part = decode_attention(q[c], kc[c], vc[c], n, hd ** -0.5)
                assert torch.equal(part, whole[c])
                part = cross_decode_attention(q[c], kc[c], vc[c], hd ** -0.5)
                assert torch.equal(part, whole_x[c])


@pytest.mark.parametrize("arch,batch", [
    ("deepseek-7b", 128), ("llama3.2-3b", 128), ("whisper-medium", 128),
    ("jamba-v0.1-52b", 128), ("jamba-v0.1-52b", 1), ("rwkv6-7b", 128)])
def test_step_specs_are_the_reference_specs_the_port_places(arch, batch):
    """A decode cell's cache specs: ``cache_pspecs``' (the reference's)
    but for the entries the port does not place yet, a batch-1 cache's
    sequence over 'data' and the recurrent state over 'model'."""
    from repro_torch.dist.sharding import AbstractMesh
    from repro_torch.serve import kvcache
    mesh = AbstractMesh((16, 16), ("data", "model"))
    cfg = get_config(arch)
    cache = model_module(cfg).init_cache(cfg, batch, 64, device="meta")
    ref = kvcache.cache_pspecs(mesh, cfg, cache, batch)
    got = kvcache.step_pspecs(mesh, cfg, cache, batch)
    assert set(got) == set(ref)
    for key, spec in got.items():
        if key in ("k", "v", "xk", "xv"):
            assert spec[-3] is None
            assert spec[:-3] + spec[-2:] == ref[key][:-3] + ref[key][-2:]
            assert "model" in spec[-2:]        # KV heads or head dim
        else:
            assert "model" not in spec
            assert [e for e in spec if e] == [e for e in ref[key]
                                              if e and e != "model"]

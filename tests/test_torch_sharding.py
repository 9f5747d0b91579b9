"""The port's logical-axis sharding against the reference's specs.

Every spec is taken on abstract meshes (no devices, no process group):
the reference's under ``use_mesh(jax.sharding.AbstractMesh(...))`` on
``jax.eval_shape`` parameters, the port's under its own ``AbstractMesh``
on a meta-device model.  The port keeps layers unstacked, so a stacked
reference leaf compares without its first entry.  The ZeRO-1 divergence
(a stacked moment never takes 'data' on its stack dim) is held to equal
per-device bytes instead.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.dist import sharding as ref_sh  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import registry as ref_reg  # noqa: E402
from repro.serve import kvcache as ref_kv  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro_torch.convert import ref_path  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import steps as steps  # noqa: E402
from repro_torch.models.registry import (ARCHS, build_model,  # noqa: E402
                                         get_config, model_module)
from repro_torch.serve import kvcache as kv  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = [(False, None), (True, None), (False, {"seq": None}),
            (False, {"heads": None, "vocab": ("data",)})]


def _meshes(name):
    shape, names = MESHES[name]
    return JaxAbstractMesh(shape, names), sh.AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_reg.get_config(arch)
    init_fn, apply_fn, cache_fn = ref_reg.build_model(cfg)
    return cfg, jax.eval_shape(init_fn, jax.random.PRNGKey(0)), apply_fn, \
        cache_fn


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    cfg = get_config(arch)
    return cfg, {n: p for n, p in build_model(cfg).named_parameters()}


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {ref_sh._path_str(p): tuple(s) for p, s in leaves}


def _ref_of(name, cfg, ref_flat):
    path, idx = ref_path(name, cfg)
    spec = ref_flat[path]
    return spec[1:] if idx is not None else spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    """All four variants: plain, ``moe_ffn_shard_data``, and two rule
    overrides; every parameter of the full-width model has a rule."""
    rcfg, rparams, _, _ = _ref_params(arch)
    cfg, state = _port_state(arch)
    jm, pm = _meshes(mesh)
    for moe, rules in VARIANTS:
        with ref_sh.use_mesh(jm, rules):
            ref_flat = _flat(ref_sh.param_pspecs(rparams, moe))
        with sh.use_mesh(pm, rules):
            port = sh.param_pspecs(state, moe)
        assert set(port) == set(state)
        for name, spec in port.items():
            assert tuple(spec) == _ref_of(name, cfg, ref_flat), \
                (name, moe, rules)
            assert len(spec) == state[name].ndim


def test_unknown_parameter_has_no_rule():
    with pytest.raises(KeyError):
        sh.param_pspecs({"layers.0.attn.mystery": np.zeros((2, 2))})


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_dedupe_drop_and_zero1_match_reference(mesh):
    jm, pm = _meshes(mesh)
    axes_cases = [("batch", "seq", None), ("batch", None, "heads"),
                  ("batch", "seq", "ffn"), ("vocab", None),
                  ("experts", "batch", None, None), ("nonsense", "kv")]
    shapes = [(32, 4096, 3072), (6, 4097, 24), (512, 64, 64), (51865, 1024),
              (16, 4, 7, 5), (8, 16)]
    for rules in (None, {"seq": None}, {"batch": ("data",)}):
        with ref_sh.use_mesh(jm, rules), sh.use_mesh(pm, rules):
            for axes, shape in zip(axes_cases, shapes):
                r = ref_sh.logical(*axes)
                p = sh.logical(*axes)
                assert tuple(p) == tuple(r)
                assert tuple(sh._drop_indivisible(p, shape)) == \
                    tuple(ref_sh._drop_indivisible(r, shape))
                assert tuple(sh._dedupe_axes(p)) == \
                    tuple(ref_sh._dedupe_axes(r))
                for spec in (r, ref_sh._dedupe_axes(r)):
                    ps = sh.P(*spec)
                    assert tuple(sh.zero1_upgrade(ps, shape, pm)) == \
                        tuple(ref_sh.zero1_upgrade(spec, shape, jm))
                assert sh._entry_size(pm, p[0]) == \
                    ref_sh._entry_size(jm, r[0])


def test_shard_is_a_no_op_without_a_mesh():
    import torch
    x = torch.ones(2, 3)
    assert sh.shard(x, "batch", None) is x
    with sh.use_mesh(sh.AbstractMesh((2, 1), ("data", "model"))):
        assert sh.shard(x, "batch", None) is x      # a local row block


def test_use_mesh_nests_and_merges_overrides():
    outer = sh.AbstractMesh((16, 16), ("data", "model"))
    inner = sh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with sh.use_mesh(outer, {"seq": None}):
        assert sh.logical("seq") == sh.P(None)
        assert sh.logical("heads") == sh.P("model")
        with sh.use_mesh(inner):
            assert sh.logical("batch", "seq") == sh.P(("pod", "data"),
                                                      "model")
        assert sh.logical("batch") == sh.P("data")
    assert sh.active_mesh() is None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_pool_pspecs_match_reference(arch, mesh):
    rcfg, _, _, cache_fn = _ref_params(arch)
    cfg, _ = _port_state(arch)
    jm, pm = _meshes(mesh)
    mod = model_module(cfg)
    for batch in (1, 8, 128):
        assert tuple(kv.kv_pspec(pm, cfg, batch)) == \
            tuple(ref_kv.kv_pspec(jm, rcfg, batch))
        assert tuple(kv.kv_pspec(pm, cfg, batch, stacked=False)) == \
            tuple(ref_kv.kv_pspec(jm, rcfg, batch, stacked=False))
        rcache = jax.eval_shape(lambda: cache_fn(batch, 64))
        ref_flat = {k: tuple(v.spec) for k, v in _flat_sh(
            ref_kv.cache_pspecs(jm, rcfg, rcache, batch)).items()}
        cache = mod.init_cache(cfg, batch, 64, device="meta")
        port = kv.cache_pspecs(pm, cfg, cache, batch)
        for key, spec in port.items():
            ref = ref_flat[_ref_cache_key(key, ref_flat)]
            # the reference stacks 'len' per layer on an encoder-decoder
            assert tuple(spec) == ref[-len(spec):], key
    pools = {k: np.zeros((5, 2, 16, cfg.n_kv_heads, cfg.hd)) for k in
             ("k", "v")}
    rp = ref_kv.pool_pspecs(jm, rcfg, pools)
    for key, spec in kv.pool_pspecs(pm, cfg, pools).items():
        assert tuple(spec) == tuple(rp[key].spec)


def _flat_sh(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {ref_sh._path_str(p): s for p, s in leaves}


def _ref_cache_key(key, ref_flat):
    """The reference's cache path of a port cache leaf."""
    cands = {"xk": ["xkv/k"], "xv": ["xkv/v"], "k": ["k", "layers/k"],
             "v": ["v", "layers/v"], "len": ["len", "layers/len"]}.get(
        key, [key])
    for c in cands:
        hits = [p for p in ref_flat if p == c or p.endswith("/" + c)]
        if hits:
            return hits[0]
    raise KeyError(key)


def _opt_bytes(spec, shape, itemsize, mesh):
    return int(np.prod(sh.local_shape(shape, mesh, sh.P(*spec)))) * itemsize


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_for_matches_reference(arch, mesh):
    """Parameter specs equal; each moment's spec equals the reference's
    where ZeRO-1 did not put 'data' on the reference's stack dim, and
    takes the same per-device bytes where it did."""
    rcfg, rparams, apply_fn, _ = _ref_params(arch)
    cfg, state = _port_state(arch)
    jm, pm = _meshes(mesh)
    moe = arch in steps.MOE_FFN_SHARD_DATA
    rtc = ref_steps.make_train_config(arch)
    tc = steps.make_train_config(arch)
    _, opt_init = ref_loop.make_train_step(apply_fn, rcfg, rtc)
    ropt = jax.eval_shape(opt_init, rparams)
    with ref_sh.use_mesh(jm):
        rp, ro = ref_loop.shardings_for(jm, rparams, ropt, rtc,
                                        moe_ffn_shard_data=moe)
    opt = make_optimizer(tc, cfg)[0](state)
    pp, po = loop.shardings_for(pm, state, opt, tc, moe_ffn_shard_data=moe,
                                cfg=cfg)
    rp_flat = {k: tuple(v.spec) for k, v in _flat_sh(rp).items()}
    for name, spec in pp.items():
        assert tuple(spec) == _ref_of(name, cfg, rp_flat)
    moved = 0
    for part in ("m", "v"):
        ref_flat = {k: tuple(v.spec) for k, v in _flat_sh(ro[part]).items()}
        for path, leaf in opt[part].items():
            for sub, t in (leaf.items() if isinstance(leaf, dict)
                           else [(None, leaf)]):
                key = path if sub is None else f"{path}/{sub}"
                ref = ref_flat[key]
                port = tuple(po[part][path] if sub is None
                             else po[part][path][sub])
                ref = ref + (None,) * (t.ndim - len(ref))
                if port != ref:
                    assert ref[0] == "data" and port[0] is None, key
                    assert _opt_bytes(port, t.shape, t.element_size(), pm) \
                        == _opt_bytes(ref, t.shape, t.element_size(), pm)
                    moved += 1
    assert tuple(po["step"]) == tuple(ro["step"].spec)
    if arch == "rwkv6-7b" and mesh == "16x16":
        # the divergence the docstring names: 32 periods divide 'data'
        key = "periods/layer_0/rwkv/w_r/w"
        assert tuple(po["m"][key]) == (None, "data", "model")
        assert moved > 0


_JAX_BLOCKS = """
import json, numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
sh = NamedSharding(mesh, PartitionSpec(("pod", "data"), "model"))
print(json.dumps({d.id: [s.start or 0 for s in idx]
                  for d, idx in sh.devices_indices_map((8, 6)).items()}))
"""


def test_placements_reproduce_jax_blocks_for_a_tuple_entry():
    """('pod', 'data') on dim 0 of a (2, 2, 2) mesh: each rank's DTensor
    block starts where JAX's block of the same mesh position does (JAX on
    eight host devices in a child process, device id = mesh position)."""
    import json
    import os
    import subprocess
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.dist.group import destroy, init_local
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _JAX_BLOCKS], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    jax_blocks = {int(k): tuple(v) for k, v in
                  json.loads(out.strip().splitlines()[-1]).items()}
    shape, names = (2, 2, 2), ("pod", "data", "model")
    spec = sh.P(("pod", "data"), "model")
    for rank in range(8):
        init_local("fake", world=8, rank=rank)
        try:
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(shape),
                              mesh_dim_names=names)
            pl = sh.placements(mesh, spec, 2)
            lshape, off = compute_local_shape_and_global_offset(
                (8, 6), mesh, pl)
            assert tuple(lshape) == sh.local_shape((8, 6), mesh, spec) \
                == (2, 3)
            assert tuple(off) == jax_blocks[rank], rank
        finally:
            destroy()
    assert not dist.is_initialized()

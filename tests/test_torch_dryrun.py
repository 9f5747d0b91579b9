"""The launch cells and the meta-device dry run (``repro_torch.launch.steps``
and ``repro_torch.launch.dryrun``) against the reference's cell algebra.

``valid_cells``, ``skip_reason``, ``input_specs``, ``batch_shardings`` and
``depth_variant`` equal the reference's.  One cell per family (dense, MoE,
rwkv6, mamba hybrid, encoder-decoder, vlm) runs at ``depth_variant(cfg,
1)`` on both production meshes under a ``fake`` group of 512 ranks and
reports ``ok`` with its bytes, FLOPs and an H100 roofline row; a dense
arch's ``long_500k`` cell reports ``skip``.  The group is destroyed by the
module fixture's finalizer (xdist runs other files in this process).
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.registry import get_config as ref_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models.registry import ARCHS, get_config  # noqa: E402

FAMILIES = [("llama3.2-3b", "train_4k"),          # dense
            ("granite-moe-3b-a800m", "decode_32k"),  # MoE
            ("rwkv6-7b", "long_500k"),            # rwkv6
            ("jamba-v0.1-52b", "decode_32k"),     # mamba hybrid
            ("whisper-medium", "train_4k"),       # encoder-decoder
            ("internvl2-76b", "prefill_32k")]     # vlm


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_algebra_matches_reference(arch):
    assert steps.valid_cells(arch) == ref_steps.valid_cells(arch)
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in SHAPES.items():
        assert steps.skip_reason(arch, name) == \
            ref_steps.skip_reason(arch, name)
        port = steps.input_specs(cfg, shape)
        ref = ref_steps.input_specs(rcfg, REF_SHAPES[name])
        assert set(port) == set(ref)
        for key, t in port.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[key].shape), key
            assert str(t.dtype).split(".")[-1] == str(ref[key].dtype), key
    for n in (1, 2):
        for seq in (1 << 30, 4096):
            a = dataclasses.asdict(steps.depth_variant(cfg, n, seq))
            b = dataclasses.asdict(ref_steps.depth_variant(rcfg, n, seq))
            assert a == b


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_shardings_match_reference(multi_pod):
    from jax.sharding import AbstractMesh
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    jm, pm = AbstractMesh(shape, names), sharding.AbstractMesh(shape, names)
    cfg, rcfg = get_config("whisper-medium"), ref_config("whisper-medium")
    for name, shp in SHAPES.items():
        port = steps.batch_shardings(pm, steps.input_specs(cfg, shp))
        ref = ref_steps.input_specs(rcfg, REF_SHAPES[name])
        # the reference builds NamedShardings; compare the entries
        dp = tuple(a for a in ("pod", "data") if a in names)
        n_dp = 32 if multi_pod else 16
        for key, spec in port.items():
            b = ref[key].shape[0]
            want = (dp if b % n_dp == 0 and b >= n_dp else None,) + \
                (None,) * (len(ref[key].shape) - 1)
            assert spec == sharding.P(*want), (name, key)


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    from repro_torch.dist.group import destroy, init_local
    if dist.is_initialized():
        pytest.fail("a process group is already up in this worker")
    init_local("fake", world=dryrun.WORLD)
    try:
        yield
    finally:
        destroy()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", FAMILIES)
def test_one_cell_per_family_runs_on_meta(fake_world, arch, shape,
                                          multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                          depth_periods=1, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["bytes_per_device"] > rec["memory"]["argument_bytes"] > 0
    assert rec["per_device"]["flops"] > 0
    row = rec["roofline"]
    assert row["hw"] == "h100-sxm" and row["bottleneck"] in (
        "compute", "memory", "collective")
    assert row["model_tflops"] > 0


def test_dense_long_context_cell_is_skipped(fake_world):
    rec = dryrun.run_cell("llama3.2-3b", "long_500k", multi_pod=False,
                          verbose=False)
    assert rec["status"] == "skip"
    assert rec["reason"] == ref_steps.skip_reason("llama3.2-3b", "long_500k")


def test_meter_counts_a_storage_once_and_releases_it():
    import torch
    with dryrun.StepMeter() as m:
        a = torch.empty(1024, device="meta")        # 4 KiB
        v = a.view(32, 32)                            # a view: no new bytes
        del a
        b = torch.empty(256, device="meta")           # 1 KiB, a still held
        del v                                         # a's storage freed
        c = torch.empty(512, device="meta")           # 2 KiB
        d = torch.empty(4, 8, device="meta") @ torch.empty(8, 16,
                                                           device="meta")
    assert m.written == 4096 + 1024 + 2048 + 128 + 512 + 256
    assert m.peak == 4096 + 1024
    assert m.flops == 2 * 4 * 8 * 16             # the matmul's formula
    del b, c, d


def test_serve_cell_with_a_prepared_plan_runs_k1_plain_on_meta(fake_world):
    """``prepare_plan=True`` on ``pallas``: the plan is programmed from the
    gathered meta weights (replicated) and each projection reaches K1's
    plain version through the wrapper's explicit meta check: the data
    axes split the 128 decode rows, so each auto-ranged projection runs
    the split launch, whose pass 1 is ``trq_group_mvm_psums_ref``."""
    from repro_torch.kernels.trq_group_mvm import ops as k1_ops
    from repro_torch.launch.mesh import make_production_mesh
    cfg = steps.depth_variant(get_config("llama3.2-3b").replace(
        pim_backend="pallas"), 1)
    cell = steps.build_serve_cell("llama3.2-3b", make_production_mesh(),
                                  "decode_32k", cfg=cfg, prepare_plan=True)
    plan = cell.args[1]
    assert plan is not None and len(plan) == 7          # one layer's
    assert cell.in_specs[1] == "replicated"
    calls = []
    origs = {name: getattr(k1_ops, name) for name in (
        "trq_group_mvm_ref", "trq_group_mvm_psums_ref")}
    for name, orig in origs.items():
        setattr(k1_ops, name, lambda *a, _f=orig, _n=name, **k: calls.append(
            _n) or _f(*a, **k))
    try:
        tokens, cache = cell.run()
    finally:
        for name, orig in origs.items():
            setattr(k1_ops, name, orig)
    assert calls == ["trq_group_mvm_psums_ref"] * 7
    assert tokens.device.type == "meta" and tuple(tokens.shape) == (128,)
    assert cache["k"].shape[1] == 128 // 16              # this rank's rows

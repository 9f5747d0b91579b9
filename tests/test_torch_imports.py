"""The port stands alone: no module of ``src/repro_torch``, no line of
``chip_smoke.py`` and none of the port's example and benchmarks imports
``jax`` or the JAX package ``repro`` (the machine with the card has no JAX;
configs and helpers are copied instead)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_trq_torch.py",
    ROOT / "benchmarks" / "serve_bench_torch.py",
    ROOT / "benchmarks" / "noise_sweep_torch.py",
    ROOT / "benchmarks" / "common_torch.py",
    ROOT / "benchmarks" / "fig3_distribution_torch.py",
    ROOT / "benchmarks" / "fig6_accuracy_torch.py",
    ROOT / "benchmarks" / "fig6c_fig7_energy_torch.py",
    ROOT / "examples" / "calibrate_cnn_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "tools" / "k1_flip_census.py",
    ROOT / "tools" / "k3_stage_race.py",
    ROOT / "tools" / "decode_heads.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    assert len(FILES) > 20
    sources = {p.name for p in (ROOT / "src" / "repro_torch").rglob("*.cu")}
    assert {"trq_group_mvm.cu", "trq_quant.cu", "xbar_mvm.cu"} <= sources
    for mod in ("core/calibrate.py", "core/distribution.py",
                "kernels/trq_quant/ops.py", "kernels/xbar_mvm/ops.py",
                "telemetry/__init__.py", "telemetry/serve_report.py",
                "pim/noise.py", "models/rwkv6.py", "configs/rwkv6_7b.py",
                "models/encdec.py", "configs/whisper_medium.py",
                "models/moe.py", "configs/granite_moe_3b_a800m.py",
                "models/mamba.py", "configs/jamba_v0_1_52b.py",
                "core/sar_adc.py", "core/coding.py", "pim/mapping.py",
                "models/cnn.py", "data/synthetic.py",
                "configs/deepseek_7b.py", "configs/glm4_9b.py",
                "configs/deepseek_67b.py", "configs/internvl2_76b.py",
                "train/loop.py", "train/optimizer.py", "ckpt/checkpoint.py",
                "launch/train.py", "launch/steps.py", "launch/mesh.py",
                "launch/dryrun.py", "dist/__init__.py", "dist/sharding.py",
                "dist/group.py", "telemetry/roofline.py"):
        assert ROOT / "src" / "repro_torch" / mod in FILES


def _c_params(src: str, fn: str):
    """Parameter types of ``extern "C" int <fn>(...)`` in a CUDA source."""
    import re
    m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', src)
    assert m, f"no extern C {fn} in the source"
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


def _ctypes_of(params):
    """The ctypes argument list a C parameter list needs."""
    import ctypes
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_longlong if "long long" in p else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("name", ["trq_group_mvm", "trq_quant", "xbar_mvm"])
def test_ctypes_bindings_match_the_c_prototypes(name):
    """The GPU compiler is not available here, so the one interface it
    cannot check — the ctypes argument list of each launcher — is held
    to the C prototype: a pointer where the C side takes a pointer, a C
    int where it takes an int, ``long long`` where it takes one; and the
    wrapper's loader of that launcher exists (the CPU path never calls
    it)."""
    import importlib
    from repro_torch.kernels import build
    assert name in build.KERNELS
    src = (build.CSRC / f"{name}.cu").read_text()
    params = _c_params(src, f"{name}_launch")
    kernel = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    assert callable(getattr(kernel, "_lib", None)), "no library loader"
    assert list(kernel._ARGTYPES) == _ctypes_of(params)


def test_score_binding_matches_its_prototype():
    """The same for the second entry of ``trq_quant.cu``, the scoring
    launcher, bound by ``_score_lib``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.trq_quant import kernel
    params = _c_params((build.CSRC / "trq_quant.cu").read_text(),
                       "trq_score_launch")
    assert callable(kernel._score_lib)
    assert list(kernel._SCORE_ARGTYPES) == _ctypes_of(params)


@pytest.mark.parametrize("entry,loader,argtypes", [
    ("decode_attn_scores_launch", "_scores_lib", "_SCORES_ARGTYPES"),
    ("decode_attn_values_launch", "_values_lib", "_VALUES_ARGTYPES")])
def test_decode_attn_bindings_match_their_prototypes(entry, loader,
                                                     argtypes):
    """The same for the two entries of ``decode_attn.cu``, a kernel of the
    port that replaces no Pallas kernel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import kernel
    assert "decode_attn" in build.KERNELS
    params = _c_params((build.CSRC / "decode_attn.cu").read_text(), entry)
    assert callable(getattr(kernel, loader))
    assert list(getattr(kernel, argtypes)) == _ctypes_of(params)


def test_the_last_public_names():
    """``trq_quant_with_ops``, ``quant_mse``, ``ideal_params``, the ambient
    QuantState, ``lm_batch`` and ``list_archs`` where the reference's
    packages export them (their values are held against the reference in
    ``test_torch_trq_quant.py``)."""
    import repro_torch.core as core
    import repro_torch.data as data
    import repro_torch.models as models
    import repro_torch.pim as pim
    assert {"trq_quant_with_ops", "quant_mse", "ideal_params",
            "use_quant_state", "active_quant_state"} <= set(dir(core))
    assert {"use_quant_state", "active_quant_state"} <= set(dir(pim))
    assert "lm_batch" in dir(data)
    assert "list_archs" in dir(models)

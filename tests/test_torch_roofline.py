"""The port's roofline (``repro_torch.telemetry.roofline``) against the
reference's: parameter counts and model FLOPs for every arch and shape,
the three terms and the bottleneck under the reference's TPU spec, and
one H100 row (the port's own spec, whose ``roofline_frac`` divides by its
own peak where the reference's divides by its TPU's whatever ``hw``)."""
import importlib

import pytest

pytest.importorskip("jax")

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.models.registry import get_config as ref_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.models.registry import ARCHS, build_model, get_config  # noqa: E402

# the packages export a function named ``roofline`` beside the module
ref = importlib.import_module("repro.telemetry.roofline")
port = importlib.import_module("repro_torch.telemetry.roofline")


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for active in (False, True):
        assert port.count_params(cfg, active) == \
            ref.count_params(rcfg, active)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        assert port.model_flops(cfg, shape) == ref.model_flops(rcfg, rshape)
        for mode in ("train", "prefill", "decode"):
            assert port.model_flops(cfg, shape, mode) == \
                ref.model_flops(rcfg, rshape, mode)
        assert port._mixer_flops_per_token(cfg, shape.seq_len) == \
            ref._mixer_flops_per_token(rcfg, rshape.seq_len)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-7b", "glm4-9b"])
def test_count_matches_the_dense_models_own_parameters(arch):
    cfg = get_config(arch)
    n = sum(p.numel() for p in build_model(cfg).parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    bias = 0 if not cfg.attn_bias else \
        cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    assert port.count_params(cfg) == n - norms - bias


def _v5e():
    v = ref.V5E
    return port.HwSpec(name=v.name, peak_flops=v.peak_flops,
                       hbm_bw=v.hbm_bw, link_bw=v.link_bw,
                       hbm_bytes=v.hbm_bytes)


@pytest.mark.parametrize("terms", [(3e18, 2e15, 1e14, 2e18),
                                   (1e15, 9e15, 1e12, 8e14),
                                   (1e12, 1e12, 5e16, 9e11)])
def test_roofline_under_the_reference_spec_matches(terms):
    flops, hbm, coll, mf = terms
    r = ref.roofline("a", "s", "16x16", 256, flops, hbm, coll, mf, 7e9)
    p = port.roofline("a", "s", "16x16", 256, flops, hbm, coll, mf, 7e9,
                      hw=_v5e())
    assert (p.compute_s, p.memory_s, p.collective_s) == \
        (r.compute_s, r.memory_s, r.collective_s)
    assert p.bottleneck == r.bottleneck and p.step_s == r.step_s
    assert p.useful_flop_frac == r.useful_flop_frac
    assert p.roofline_frac == pytest.approx(r.roofline_frac, rel=1e-15)
    row, rrow = p.row(), r.row()
    assert row.pop("hw") == "tpu-v5e"
    assert set(row) == set(rrow)
    for key, val in rrow.items():
        assert row[key] == (val if isinstance(val, str)
                            else pytest.approx(val, rel=1e-15)), key


def test_h100_row_divides_by_its_own_peak():
    """The divergence: under the H100 spec the port's roofline_frac is
    MODEL_FLOPS / (chips x 989 TFLOP/s) / step_s; the reference's formula
    would divide by its TPU's 197 TFLOP/s."""
    h = port.H100
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    r = port.roofline("llama3.2-3b", "train_4k", "16x16", 256,
                      hlo_flops=2.0e18, hlo_bytes=1.0e15,
                      collective_bytes=1.0e14, model_flops=1.0e18)
    assert r.hw is h and r.bottleneck == "compute"
    assert r.compute_s == 2.0e18 / (256 * 989e12)
    assert r.roofline_frac == pytest.approx(0.5, rel=1e-12)
    ref_formula = 1.0e18 / (256 * ref.V5E.peak_flops) / r.step_s
    assert ref_formula == pytest.approx(0.5 * 989 / 197, rel=1e-12)
    assert r.row()["hw"] == "h100-sxm"


def test_chip_smoke_takes_its_card_rates_from_the_roofline():
    import ast
    import pathlib
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    assigned = {t.id for node in ast.walk(tree)
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    for name in ("HBM_BYTES_PER_S", "F32_FLOP_PER_S", "B1_OPS_PER_S"):
        assert name not in assigned
        assert hasattr(port, name)
    imported = {a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                and node.module == "repro_torch.telemetry.roofline"
                for a in node.names}
    assert {"HBM_BYTES_PER_S", "F32_FLOP_PER_S", "B1_OPS_PER_S"} <= imported
    assert port.HBM_BYTES_PER_S == port.H100.hbm_bw

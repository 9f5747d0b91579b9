"""Card-only checks of the port: the CUDA kernel against its plain version,
and the entry points on their default device.  Every test carries the
``cuda`` marker and skips without a card.  This file imports neither
``jax`` nor ``repro``, so it runs on the GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trq import make_params  # noqa: E402
from repro_torch.kernels.trq_group_mvm import kernel as k1  # noqa: E402
from repro_torch.kernels.trq_group_mvm import pack_scalars  # noqa: E402
from repro_torch.kernels.trq_group_mvm.ref import \
    trq_group_mvm_ref  # noqa: E402

REGS = [dict(n_r1=6, n_r2=6, m=4, bias=0.0),
        dict(n_r1=2, n_r2=6, m=1, bias=0.0),
        dict(n_r1=3, n_r2=5, m=4, bias=3.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _regs(p):
    return dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["twin", "uniform"])
@pytest.mark.parametrize("rk", REGS, ids=["r6-6", "r2-6", "r3-5-b3"])
@pytest.mark.parametrize("m,k,n", [(3, 300, 130), (16, 256, 64),
                                   (65, 384, 200)])
def test_kernel_exact_on_integer_inputs(card, m, k, n, rk, mode):
    """Integer operands, power-of-two steps and grid: every partial sum is
    exact in f32, so kernel and plain version agree bit for bit."""
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(np.float32))
    p = make_params(delta_r1=16.0, signed=True, mode=mode, device=card,
                    **rk)
    s = pack_scalars(p, torch.tensor(0.5), card)
    before = k1.LAUNCHES
    y, ops = k1.trq_group_mvm_cuda(a.to(card), w.to(card), s, **_regs(p))
    assert k1.LAUNCHES == before + 1
    y_r, ops_r = trq_group_mvm_ref(a.to(card), w.to(card), s, **_regs(p))
    torch.cuda.synchronize()
    assert torch.equal(y, y_r)
    assert int(ops) == int(ops_r)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 256, 136], ids=["n300", "n256", "n136"])
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("auto_range", [False, True], ids=["given", "auto"])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 64])
def test_kernel_exact_with_auto_range_and_bf16_weights(card, m, auto_range,
                                                       wdtype, n):
    """Integer operands (exact in bf16 too): kernel and plain version agree
    bit for bit with the registers given or auto-ranged from the call's own
    maximum, at every m-tile height the kernel picks, with K ragged and N
    ragged (300: element loads), aligned (256) or ragged in whole 16-byte
    rows (136); bf16 at M <= 16 with aligned rows takes the TMA body."""
    rng = np.random.default_rng(m * 1000 + n)
    a = torch.from_numpy(rng.integers(-8, 9, (m, 700)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 9, (700, n)).astype(np.float32))
    p = make_params(delta_r1=1.0 if auto_range else 16.0, n_r1=2, n_r2=6,
                    m=1, signed=True, device=card)
    s = pack_scalars(p, torch.tensor(0.5), card)
    kw = dict(_regs(p), auto_range=auto_range)
    a, w = a.to(card), w.to(card, wdtype)
    before = k1.LAUNCHES
    y, ops = k1.trq_group_mvm_cuda(a, w, s, **kw)
    assert k1.LAUNCHES == before + 1
    y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r)
    assert int(ops) == int(ops_r)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    s = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        k1.trq_group_mvm_cuda(torch.zeros(2, 128, device=card).half(),
                              torch.zeros(128, 4, device=card), s,
                              n_r1=4, n_r2=4, m=3)
    with pytest.raises(ValueError, match="do not contract"):
        k1.trq_group_mvm_cuda(torch.zeros(2, 128, device=card),
                              torch.zeros(64, 4, device=card), s,
                              n_r1=4, n_r2=4, m=3)
    with pytest.raises(ValueError, match="bfloat16 or float32 CUDA"):
        k1.trq_group_mvm_cuda(torch.zeros(2, 128, device=card),
                              torch.zeros(128, 4, device=card).half(), s,
                              n_r1=4, n_r2=4, m=3)


@pytest.mark.cuda
def test_runtime_defaults_to_the_card_and_launches_the_kernel(card):
    from repro_torch import runtime
    from repro_torch.models.registry import get_config, init
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="pallas", param_dtype="bfloat16")
    rt = runtime.compile(cfg, init(cfg, seed=0, device=card))
    assert rt.device.type == "cuda"
    before = k1.LAUNCHES
    (logits, _), rep = rt.prefill(np.zeros((1, 16), np.int32), max_len=32)
    assert k1.LAUNCHES - before == 7 * cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert rep.total() == 7 * 16 * cfg.n_layers * sum(
        n * -(-kk // 128) for kk, n in [(96, 96), (96, 32), (96, 32),
                                        (96, 96), (96, 192), (96, 192),
                                        (192, 96)])


# ---------------------------------------------------------------------------
# trq_quant (K2) and xbar_mvm (K3)
# ---------------------------------------------------------------------------

PARAM_GRID = [dict(n_r1=4, n_r2=4, m=3, bias=0.0),
              dict(n_r1=2, n_r2=6, m=1, bias=0.0),
              dict(n_r1=3, n_r2=5, m=4, bias=3.0),
              dict(n_r1=7, n_r2=7, m=0, bias=0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("signed,mode", [(True, "twin"), (False, "twin"),
                                         (True, "uniform")])
@pytest.mark.parametrize("pk", PARAM_GRID, ids=["4-4", "2-6", "3-5-b3",
                                                "7-7"])
def test_trq_quant_kernel_equals_plain(card, pk, signed, mode, dtype):
    from repro_torch.kernels.trq_quant import kernel as k2
    from repro_torch.kernels.trq_quant.ref import trq_quant_ref
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 30, (37, 1029)).astype(
        np.float32)).to(card, dtype)
    s = torch.tensor([0.7, pk["bias"]], device=card)
    regs = dict(n_r1=pk["n_r1"], n_r2=pk["n_r2"], m=pk["m"], mode=mode,
                signed=signed)
    before = k2.LAUNCHES
    q, ops = k2.trq_quant_cuda(x, s, **regs)
    assert k2.LAUNCHES == before + 1
    q_r, ops_r = trq_quant_ref(x, s, **regs)
    torch.cuda.synchronize()
    assert q.shape == x.shape and q.dtype == torch.float32
    assert torch.equal(q, q_r) and torch.equal(ops, ops_r)


def _xbar_operands(rng, card, m, k, n):
    from repro_torch.kernels.xbar_mvm import pack_planes, pack_weight_planes
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int32))
    return (pack_planes(a.to(card), 8),
            pack_weight_planes((w + 128).to(card), 8))


@pytest.mark.cuda
@pytest.mark.parametrize("regs", [None, dict(delta_r1=1.0, n_r1=6, n_r2=6,
                                             m=4),
                                  dict(delta_r1=0.7, n_r1=3, n_r2=5, m=4,
                                       bias=3.0),
                                  dict(delta_r1=1.0, n_r1=4, n_r2=4, m=3,
                                       mode="uniform")],
                         ids=["lossless", "default", "frac-bias", "uniform"])
@pytest.mark.parametrize("m,k,n", [(3, 300, 130), (4, 256, 64),
                                   (21, 384, 40)])
def test_xbar_mvm_kernel_equals_plain(card, m, k, n, regs):
    """Bit-line sums are exact integers and the plain version accumulates
    in the kernel's order, so y, the per-output ops and the total agree
    bit for bit."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm import pack_scalars as k3_scalars
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    rng = np.random.default_rng(m * k + n)
    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    p = make_params(device=card, **regs) if regs else None
    kw = dict(lossless=p is None, per_output=True)
    if p is not None:
        kw.update(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)
    s = k3_scalars(p, card)
    before = k3.LAUNCHES
    acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s, **kw)
    assert k3.LAUNCHES == before + 1
    acc_r, ops_r, per_r = xbar_mvm_ref(a_mask, w_mask, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_r)
    assert torch.equal(per, per_r) and int(ops) == int(ops_r)


@pytest.mark.cuda
def test_bit_exact_runtime_launches_xbar_mvm(card):
    from repro_torch import runtime
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.registry import get_config, init
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="bit_exact", param_dtype="bfloat16")
    rt = runtime.compile(cfg, init(cfg, seed=0, device=card))
    before = k3.LAUNCHES
    (logits, _), rep = rt.prefill(np.zeros((1, 16), np.int32), max_len=32)
    assert k3.LAUNCHES - before == 7 * cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    # every conversion costs nu + n_r = 7 ops at the default registers
    assert rep.total() == 7 * 64 * 16 * cfg.n_layers * sum(
        n * -(-kk // 128) for kk, n in [(96, 96), (96, 32), (96, 32),
                                        (96, 96), (96, 192), (96, 192),
                                        (192, 96)])


@pytest.mark.cuda
def test_calibration_scores_through_trq_quant(card):
    from repro_torch.core.calibrate import calibrate_layer
    from repro_torch.kernels.trq_quant import kernel as k2
    rng = np.random.default_rng(0)
    y = np.round(np.abs(rng.normal(0, 2.5, 20_000)))
    before = k2.LAUNCHES
    got = calibrate_layer(torch.from_numpy(y).to(card), n_max=7)
    assert k2.LAUNCHES > before
    want = calibrate_layer(y, n_max=7)          # plain version, CPU
    assert (got.chosen, got.params.n_r1, got.params.n_r2, got.params.m,
            float(got.params.delta_r1), float(got.params.bias)) == (
        want.chosen, want.params.n_r1, want.params.n_r2, want.params.m,
        float(want.params.delta_r1), float(want.params.bias))

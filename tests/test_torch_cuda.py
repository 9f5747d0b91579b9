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


def _xbar_operands(rng, card, m, k, n, k_i=8, k_w=8):
    from repro_torch.kernels.xbar_mvm import pack_planes, pack_weight_planes
    a = torch.from_numpy(rng.integers(0, 2 ** k_i, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2 ** (k_w - 1), 2 ** (k_w - 1),
                                      (k, n)).astype(np.int32))
    return (pack_planes(a.to(card), k_i),
            pack_weight_planes((w + 2 ** (k_w - 1)).to(card), k_w))


def _xbar_kwargs(card, regs):
    from repro_torch.kernels.xbar_mvm import pack_scalars as k3_scalars
    p = make_params(device=card, **regs) if regs else None
    kw = dict(lossless=p is None)
    if p is not None:
        kw.update(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)
    return k3_scalars(p, card), kw


@pytest.mark.cuda
@pytest.mark.parametrize("per_output", [True, False], ids=["per", "total"])
@pytest.mark.parametrize("bits", [(8, 8), (4, 4), (8, 4)],
                         ids=["8x8", "4x4", "8x4"])
@pytest.mark.parametrize("regs", [None, dict(delta_r1=1.0, n_r1=6, n_r2=6,
                                             m=4),
                                  dict(delta_r1=0.7, n_r1=3, n_r2=5, m=4,
                                       bias=3.0),
                                  dict(delta_r1=1.0, n_r1=4, n_r2=4, m=3,
                                       mode="uniform")],
                         ids=["lossless", "default", "frac-bias", "uniform"])
@pytest.mark.parametrize("k,n", [(300, 130), (1000, 40), (100, 72),
                                 (300, 1100), (256, 64)])
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 64])
def test_xbar_mvm_kernel_equals_plain(card, m, k, n, regs, bits, per_output):
    """Bit-line sums are exact integers and the plain version accumulates
    in the kernel's order, so y, the per-output ops and the total agree
    bit for bit: at every row tile (M = 1 .. 64), with K past the last
    full group, N past the last column tile, both aligned (256 x 64), one
    group (no split) or several split among a cluster's blocks, and
    narrow bit widths (the general body)."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    rng = np.random.default_rng(m * k + n)
    a_mask, w_mask = _xbar_operands(rng, card, m, k, n, *bits)
    s, kw = _xbar_kwargs(card, regs)
    before = k3.LAUNCHES
    acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s,
                                     per_output=per_output, **kw)
    assert k3.LAUNCHES == before + 1
    acc_r, ops_r, per_r = xbar_mvm_ref(a_mask, w_mask, s,
                                       per_output=per_output, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_r)
    assert int(ops) == int(ops_r)
    if per_output:
        assert torch.equal(per, per_r)
    else:
        assert per is None and per_r is None


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [4, 16])
def test_xbar_mvm_split_does_not_change_results(card, m, split):
    """The groups of an output tile split among 1, 2, 4 or 8 blocks of a
    cluster and folded in group order give the same bits.  N is chosen so
    that the wrapper's shape plan picks ``split`` on this card: the
    largest split that keeps ``tiles * split`` blocks in one wave."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    k, g = 1100, 9
    sms = k3.sm_count(card)
    m_tiles = -(-m // (4 if m <= 4 else 8))
    n = k3.BLOCKS_PER_SM * sms // split // m_tiles * k3.BLOCK_COLS - 5
    assert k3.plan(m, g, n, 8, 8, sms).split == split
    rng = np.random.default_rng(7)
    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    s, kw = _xbar_kwargs(card, dict(delta_r1=0.7, n_r1=3, n_r2=5, m=4,
                                    bias=3.0))
    want = xbar_mvm_ref(a_mask, w_mask, s, per_output=True, **kw)
    got = k3.xbar_mvm_cuda(a_mask, w_mask, s, per_output=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2]) and int(got[1]) == int(want[1])


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
    """A layer's calibration is one launch of the scoring entry and no
    elementwise K2 launch, and picks what the plain version picks on the
    CPU with the same scores bit for bit (integer samples: exact sums)."""
    from repro_torch.core.calibrate import calibrate_layer
    from repro_torch.kernels.trq_quant import kernel as k2
    rng = np.random.default_rng(0)
    y = np.round(np.abs(rng.normal(0, 2.5, 20_000)))
    before = k2.LAUNCHES, k2.SCORE_LAUNCHES
    got = calibrate_layer(torch.from_numpy(y).to(card), n_max=7)
    assert (k2.LAUNCHES, k2.SCORE_LAUNCHES) == (before[0], before[1] + 1)
    want = calibrate_layer(y, n_max=7)          # plain version, CPU
    assert _calibration(got) == _calibration(want)


def _calibration(c):
    """A layer's pick and its scores, as plain values."""
    p = c.params
    return (c.chosen, p.mode, p.n_r1, p.n_r2, p.m, p.nu, float(p.delta_r1),
            float(p.bias), c.mse, c.mean_ops, c.uniform_mse)


def _score_table(table, n):
    """The first ``n`` of 65,536 samples and the candidates of
    chip_smoke.py's phase-5 tables: the PARAM_GRID registers (signed,
    unsigned, uniform; steps 1.0 and 0.7) on random floats, and the tables
    calibrate_layer builds for integer bit-line-like samples of a
    ``normal`` and an ``other`` layer."""
    from repro_torch.core.calibrate import layer_candidates
    from repro_torch.core.distribution import classify
    rng = np.random.default_rng(12)
    if table == "param_grid":
        y = rng.normal(0, 30, 65536)
        modes = [dict(signed=True), dict(signed=False),
                 dict(signed=True, mode="uniform")]
        return y[:n].astype(np.float32), [
            make_params(delta_r1=d, **pk, **mode) for pk in PARAM_GRID
            for mode in modes for d in (1.0, 0.7)]
    y = rng.normal(32, 3, 65536).round() if table == "normal" else \
        rng.integers(0, 129, 65536)
    dist = classify(y)
    assert dist.kind == table
    _, uniform, twin = layer_candidates(dist, n_max=7)
    return y[:n].astype(np.float32), uniform + twin


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 5001])
@pytest.mark.parametrize("table", ["param_grid", "normal", "other"])
def test_trq_score_kernel_equals_plain(card, table, n):
    """Op sums equal; squared-error sums equal once rounded to f32 (what
    the search reads), and bitwise in f64 where every error is an integer
    (integer samples on an integral step: the TRQ candidates of the
    normal table; its uniform fallbacks have fractional steps)."""
    from repro_torch.kernels.trq_quant import kernel as k2, score_table
    from repro_torch.kernels.trq_quant.ref import trq_score_ref
    y, cands = _score_table(table, n)
    y = torch.from_numpy(y).to(card)
    fregs, iregs = score_table(cands, card)
    before = k2.SCORE_LAUNCHES
    sq, ops = k2.trq_score_cuda(y, fregs, iregs)
    assert k2.SCORE_LAUNCHES == before + 1
    sq_r, ops_r = trq_score_ref(y, fregs, iregs)
    again = k2.trq_score_cuda(y, fregs, iregs)
    torch.cuda.synchronize()
    assert sq.shape == ops.shape == (len(cands),)
    assert torch.equal(ops, ops_r)
    assert torch.equal(sq.float(), sq_r.float())
    assert torch.equal(sq, again[0]) and torch.equal(ops, again[1])
    exact = [i for i, p in enumerate(cands) if table != "param_grid"
             and float(p.delta_r1).is_integer()]
    assert len(exact) >= (104 if table == "normal" else 0)
    assert torch.equal(sq[exact], sq_r[exact])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "other"])
def test_calibrate_layer_on_the_card_equals_plain(card, kind):
    from repro_torch.core.calibrate import calibrate_layer
    y, _ = _score_table(kind, 65536)
    got = calibrate_layer(torch.from_numpy(y).to(card), n_max=7)
    assert _calibration(got) == _calibration(calibrate_layer(y, n_max=7))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "bit_exact", "noisy"])
@pytest.mark.parametrize("scan", [True, False])
def test_census_sums_to_the_engine_total_on_the_card(card, backend, scan):
    """The per-layer census of a served trace adds up to the engine's
    metered total bit for bit, with every value a 0-dim int64 tensor on
    the card; with no tally open the same trace meters the same total."""
    from repro_torch import runtime
    from repro_torch.models.registry import get_config, init
    from repro_torch.pim import ad_ops_tally
    from repro_torch.serve import ServeEngine
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend=backend, param_dtype="bfloat16", scan_layers=scan)
    rt = runtime.compile(cfg, init(cfg, seed=0, device=card))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (12, 20, 9)]
    totals = []
    for tally in (True, False):
        eng = ServeEngine(rt, max_batch=2, max_len=64)
        for p in prompts:
            eng.submit(p, max_new_tokens=3)
        if tally:
            with ad_ops_tally() as t:
                eng.run()
        else:
            eng.run()
        totals.append(eng.stats()["total_ad_ops"])
    assert len(t.by_layer) == 7 * (1 if scan else cfg.n_layers)
    assert all(v.device.type == "cuda" and v.dtype == torch.int64
               for v in t.by_layer.values())
    assert t.total() == totals[0] == totals[1] > 0


# ---------------------------------------------------------------------------
# whisper-medium's projection shapes, at a decode batch and 1,500 encoder
# rows (a 30-second window; a multiple of no row tile)
# ---------------------------------------------------------------------------

WHISPER_KN = [(1024, 1024), (1024, 4096), (4096, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("auto_range", [False, True], ids=["given", "auto"])
@pytest.mark.parametrize("k,n", WHISPER_KN, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [4, 1500])
def test_kernel_equals_plain_at_whisper_shapes(card, m, k, n, auto_range):
    """K1 on integer operands with bf16 weights (exact in f32 and bf16):
    y and ops bit for bit at K = 1,024 (8 groups) and 4,096, M = 4 (the
    TMA body) and 1,500."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(np.float32))
    p = make_params(delta_r1=1.0 if auto_range else 16.0, signed=True,
                    device=card, **REGS[0])
    s = pack_scalars(p, torch.tensor(0.5), card)
    kw = dict(_regs(p), auto_range=auto_range)
    a, w = a.to(card), w.to(card, torch.bfloat16)
    before = k1.LAUNCHES
    y, ops = k1.trq_group_mvm_cuda(a, w, s, **kw)
    assert k1.LAUNCHES == before + 1
    y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r)
    assert int(ops) == int(ops_r)


@pytest.mark.cuda
@pytest.mark.parametrize("regs", [None, dict(delta_r1=1.0, n_r1=6, n_r2=6,
                                             m=4)],
                         ids=["lossless", "default"])
@pytest.mark.parametrize("k,n", WHISPER_KN, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [4, 1500])
def test_xbar_mvm_kernel_equals_plain_at_whisper_shapes(card, m, k, n,
                                                        regs):
    """K3 at whisper's shapes: y, the per-output ops and the total bit for
    bit (the plain version a block of 256 columns at a time: its bit-line
    sums at M = 1,500, K = 4,096 would take 12.6 GB at once; columns are
    independent)."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    rng = np.random.default_rng(m + k + n)
    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    s, kw = _xbar_kwargs(card, regs)
    before = k3.LAUNCHES
    acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s, per_output=True,
                                     **kw)
    assert k3.LAUNCHES == before + 1
    total = 0
    for c in range(0, n, 256):
        acc_r, ops_r, per_r = xbar_mvm_ref(
            a_mask, w_mask[:, :, c:c + 256].contiguous(), s,
            per_output=True, **kw)
        assert torch.equal(acc[:, c:c + 256], acc_r)
        assert torch.equal(per[:, c:c + 256], per_r)
        total += int(ops_r)
    assert int(ops) == total


@pytest.mark.cuda
def test_xbar_mvm_repeats_bit_for_bit_beside_other_work(card):
    """K3 at whisper's 1,500-row prefill shapes, launched 2,000 times each
    while a second stream runs copies and matmuls: every output equals
    the first, bit for bit.  A consumer warp that released a weight stage
    without a proxy fence let the producer's next bulk copy land before
    one of its reads, now and then (one weight word of one block off;
    ``tools/k3_stage_race.py`` counts it)."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    rng = np.random.default_rng(11)
    side = torch.cuda.Stream()
    big = torch.empty(64 * 2 ** 20, device=card)
    mm_a = torch.randn(2048, 2048, device=card)
    s, kw = _xbar_kwargs(card, dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4))
    for k, n in [(4096, 1024), (1024, 1024), (1024, 4096)]:
        a_mask, w_mask = _xbar_operands(rng, card, 1500, k, n)
        base = k3.xbar_mvm_cuda(a_mask, w_mask, s, **kw)[0].clone()
        outs, off = [], 0
        for i in range(2000):
            if i % 25 == 0:
                with torch.cuda.stream(side):
                    big.mul_(1.0001)
                    torch.mm(mm_a, mm_a)
            outs.append(k3.xbar_mvm_cuda(a_mask, w_mask, s, **kw)[0])
            if len(outs) == 50:
                off += sum(not torch.equal(o, base) for o in outs)
                outs = []
        torch.cuda.synchronize()
        assert off == 0, f"{off} of 2000 launches at {k} x {n} off"


@pytest.mark.cuda
def test_trq_group_mvm_tma_repeats_bit_for_bit_beside_other_work(card):
    """K1's TMA body at granite-moe-3b-a800m's decode shapes (1,536 ->
    1,536 / 512, bf16 weights, M = 4), launched 2,000 times each while a
    second stream runs copies and matmuls: every output equals the first,
    bit for bit, and equals the plain version's on integer operands."""
    rng = np.random.default_rng(12)
    side = torch.cuda.Stream()
    big = torch.empty(64 * 2 ** 20, device=card)
    mm_a = torch.randn(2048, 2048, device=card)
    p = make_params(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True,
                    device=card)
    s = pack_scalars(p, torch.tensor(0.5), card)
    kw = dict(_regs(p), auto_range=True)
    for k, n in [(1536, 1536), (1536, 512)]:
        a = torch.from_numpy(rng.integers(-8, 9, (4, k)).astype(
            np.float32)).to(card)
        w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(
            np.float32)).to(card, torch.bfloat16)
        base = k1.trq_group_mvm_cuda(a, w, s, **kw)[0].clone()
        assert torch.equal(base, trq_group_mvm_ref(a, w, s, **kw)[0])
        outs, off = [], 0
        for i in range(2000):
            if i % 25 == 0:
                with torch.cuda.stream(side):
                    big.mul_(1.0001)
                    torch.mm(mm_a, mm_a)
            outs.append(k1.trq_group_mvm_cuda(a, w, s, **kw)[0])
            if len(outs) == 50:
                off += sum(not torch.equal(o, base) for o in outs)
                outs = []
        torch.cuda.synchronize()
        assert off == 0, f"{off} of 2000 launches at {k} x {n} off"


def _beside_other_work(card, launch, base, n: int = 1000) -> int:
    """Launches of ``launch()`` (``n`` of them, a second stream running
    copies and matmuls every 25) whose output differs from ``base``."""
    side = torch.cuda.Stream()
    big = torch.empty(64 * 2 ** 20, device=card)
    mm_a = torch.randn(2048, 2048, device=card)
    outs, off = [], 0
    for i in range(n):
        if i % 25 == 0:
            with torch.cuda.stream(side):
                big.mul_(1.0001)
                torch.mm(mm_a, mm_a)
        outs.append(launch())
        if len(outs) == 50:
            off += sum(not torch.equal(o, base) for o in outs)
            outs = []
    torch.cuda.synchronize()
    return off


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16])
def test_kernels_equal_plain_at_jamba_x_proj(card, m):
    """jamba's ``x_proj`` (8,192 -> 288: K1's 128-column blocks end on a
    ragged 32, K3's 32-column blocks on a whole nine) at decode rows:
    K1 (the TMA body, bf16 weights, auto-ranged) and K3 bit for bit
    against their plain versions on integer operands, ops equal, and
    every one of 1,000 launches beside other work equal to the first."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    k, n = 8192, 288
    rng = np.random.default_rng(21 + m)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(
        np.float32)).to(card)
    w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(
        np.float32)).to(card, torch.bfloat16)
    p = make_params(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True,
                    device=card)
    s = pack_scalars(p, torch.tensor(0.5), card)
    kw = dict(_regs(p), auto_range=True)
    y, ops = k1.trq_group_mvm_cuda(a, w, s, **kw)
    y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r) and int(ops) == int(ops_r)
    assert _beside_other_work(
        card, lambda: k1.trq_group_mvm_cuda(a, w, s, **kw)[0], y) == 0

    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    s3, kw3 = _xbar_kwargs(card, dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4))
    acc, ops3, per = k3.xbar_mvm_cuda(a_mask, w_mask, s3, per_output=True,
                                      **kw3)
    acc_r, ops3_r, per_r = xbar_mvm_ref(a_mask, w_mask, s3,
                                        per_output=True, **kw3)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_r) and torch.equal(per, per_r)
    assert int(ops3) == int(ops3_r)
    assert _beside_other_work(
        card, lambda: k3.xbar_mvm_cuda(a_mask, w_mask, s3, **kw3)[0],
        acc) == 0


# glm4-9b's wk/wv (two KV heads) and untied lm_head, and internvl2-76b's
# w_gate/w_up at d = 8,192
DENSE_KN = [(4096, 256), (4096, 151552), (8192, 28672)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", DENSE_KN, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [1, 4])
def test_kernels_equal_plain_at_glm4_and_internvl2_shapes(card, m, k, n):
    """K1 (bf16 weights, auto-ranged: the TMA body at these M) and K3
    bit for bit against their plain versions on integer operands at decode
    rows, ops equal (K3's plain version 8,192 columns at a time: its
    unpacked weight planes take 32 bytes a weight)."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(
        np.float32)).to(card)
    w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(
        np.float32)).to(card, torch.bfloat16)
    p = make_params(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True,
                    device=card)
    s = pack_scalars(p, torch.tensor(0.5), card)
    kw = dict(_regs(p), auto_range=True)
    y, ops = k1.trq_group_mvm_cuda(a, w, s, **kw)
    y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r) and int(ops) == int(ops_r)
    del a, w, y_r

    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    s3, kw3 = _xbar_kwargs(card, dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4))
    acc, ops3, per = k3.xbar_mvm_cuda(a_mask, w_mask, s3, per_output=True,
                                      **kw3)
    total = 0
    for c in range(0, n, 8192):
        acc_r, ops_r, per_r = xbar_mvm_ref(
            a_mask, w_mask[:, :, c:c + 8192].contiguous(), s3,
            per_output=True, **kw3)
        assert torch.equal(acc[:, c:c + 8192], acc_r)
        assert torch.equal(per[:, c:c + 8192], per_r)
        total += int(ops_r)
    assert int(ops3) == total


# the paper's CNNs on K3: (M, K, N) of LeNet-5's conv0 at 256 images
# (200,704 rows, N = 6 of a 32-column tile, K = 25 in one part-filled
# group), decode-sized rows of the narrow layers, ResNet-20's widest convs
CNN_K3_SHAPES = [(200704, 25, 6), (1, 25, 6), (4, 27, 16), (17, 150, 16),
                 (4096, 576, 64), (256, 400, 120), (5, 84, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("regs", [None,
                                  dict(delta_r1=1.0, n_r1=4, n_r2=4, m=3),
                                  dict(delta_r1=2.5, n_r1=4, n_r2=4, m=0,
                                       mode="uniform")],
                         ids=["lossless", "twin", "uniform"])
@pytest.mark.parametrize("m,k,n", CNN_K3_SHAPES)
def test_xbar_mvm_kernel_equals_plain_at_cnn_shapes(card, m, k, n, regs):
    """K3 at the CNNs' shapes, bit for bit against its plain version: N
    as small as 6, K = 25 and 27 (one part-filled group), M up to one
    256-image batch of LeNet-5's first conv."""
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    rng = np.random.default_rng(m + k + n)
    a_mask, w_mask = _xbar_operands(rng, card, m, k, n)
    s, kw = _xbar_kwargs(card, regs)
    acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s, per_output=True,
                                     **kw)
    acc_r, ops_r, per_r = xbar_mvm_ref(a_mask, w_mask, s, per_output=True,
                                       **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_r) and torch.equal(per, per_r)
    assert int(ops) == int(ops_r)


@pytest.mark.cuda
def test_lenet_runs_every_layer_through_xbar_mvm(card):
    """LeNet-5's PIM forward on the card: one K3 launch a conv or FC layer,
    the lossless op total equal to the closed form of the real shapes,
    and the logits those of the plain version on the CPU (same weights
    and images; float convs in another order may move a requantized code,
    so the bar is relative L2 1e-2 with the same argmax)."""
    from repro_torch.data.synthetic import vision_dataset
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models import cnn
    params = cnn.init_cnn(cnn.LENET5, seed=0, device=card)
    x, _ = vision_dataset(8, noise=0.8, device=card)
    q = cnn.quantize_cnn(params, cnn.LENET5, x)
    before = k3.LAUNCHES
    logits, ops = cnn.pim_forward(q, x, None, with_ops=True)
    assert k3.LAUNCHES - before == len(q.pim_layers) == 5
    assert int(ops) == 8 * 8 * cnn.real_conversions(cnn.LENET5)
    cpu = {n: {k: v.cpu() for k, v in p.items()} for n, p in params.items()}
    q_cpu = cnn.quantize_cnn(cpu, cnn.LENET5, x.cpu())
    want = cnn.pim_forward(q_cpu, x.cpu(), None)
    got = logits.cpu()
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-2
    assert torch.equal(got.argmax(-1), want.argmax(-1))

"""Parity of the port's ``xbar_mvm`` (K3) with the reference Pallas kernel
``repro.kernels.xbar_mvm_pallas`` (interpret mode on the CPU) and with the
bit-exact simulator ``repro.pim.crossbar.bit_exact_mvm``.

On CPU tensors the port runs the kernel's plain version
(``kernels/xbar_mvm/ref.py``: f32 0/1 plane einsums, accumulated in the
kernel's order); the CUDA kernel is held against it on the card.  Bars are
the reference's own (``tests/test_kernels.py``): ``atol=0`` with
per-output op counts equal; lossless mode equals the int64 matmul with
8·8·G ops per output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.trq import make_params as jmake  # noqa: E402
from repro.kernels import xbar_mvm_pallas  # noqa: E402
from repro.pim.crossbar import PimConfig as JPimConfig  # noqa: E402
from repro.pim.crossbar import bit_exact_mvm as jbit_exact  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.kernels.xbar_mvm import (pack_planes,  # noqa: E402
                                          pack_weight_planes, xbar_mvm,
                                          xbar_mvm_2d)
from repro_torch.kernels.xbar_mvm.ref import unpack_planes  # noqa: E402
from repro_torch.pim.crossbar import bitplanes  # noqa: E402

SHAPES = [(8, 128, 16), (4, 256, 8), (3, 100, 5)]
REGS = [dict(delta_r1=1.0, n_r1=4, n_r2=6, m=2),
        dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True),
        dict(delta_r1=1.0, n_r1=3, n_r2=5, m=4, bias=3.0, nu=2),
        dict(delta_r1=1.0, n_r1=4, n_r2=4, m=3, mode="uniform")]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(43)


def _operands(rng, m, k, n, k_i=8, k_w=8):
    a = rng.integers(0, 2 ** k_i, (m, k)).astype(np.int32)
    w = rng.integers(-2 ** (k_w - 1), 2 ** (k_w - 1), (k, n)).astype(np.int32)
    return a, w


@pytest.mark.parametrize("regs", REGS, ids=["r4-6", "default", "bias3",
                                            "uniform"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_xbar_mvm_matches_pallas_and_simulator(rng, m, k, n, regs):
    a, w = _operands(rng, m, k, n)
    y_k, ops_k = xbar_mvm_pallas(jnp.asarray(a), jnp.asarray(w),
                                 jmake(**regs), interpret=True)
    y_s, ops_s = jbit_exact(jnp.asarray(a), jnp.asarray(w), jmake(**regs),
                            with_ops=True)
    y_t, ops_t = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w),
                          tmake(**regs))
    assert ops_t.shape == (m, n) and ops_t.dtype == torch.int32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_k), atol=0)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_s), atol=0)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_k))
    assert int(ops_t.sum()) == float(ops_s)
    _, total = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w),
                        tmake(**regs), per_output=False)
    assert total.dtype == torch.int64 and int(total) == int(ops_t.sum())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_lossless_mode_is_the_int_matmul(rng, m, k, n):
    a, w = _operands(rng, m, k, n)
    y_t, ops_t = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w), None)
    y_k, ops_k = xbar_mvm_pallas(jnp.asarray(a), jnp.asarray(w), None,
                                 interpret=True)
    np.testing.assert_array_equal(y_t.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_k))
    # lossless = a full 8-op conversion for every (b, c, group)
    assert bool((ops_t == 8 * 8 * 8 * -(-k // 128)).all())


def test_fractional_step_matches_pallas_bitwise(rng):
    """With a non-integer delta_r1 the quantized sums are not integers; the
    plain version accumulates in the kernel's order, so it still equals
    the TPU kernel bit for bit."""
    a, w = _operands(rng, 8, 300, 16)
    regs = dict(delta_r1=0.7, n_r1=3, n_r2=5, m=4, bias=3.0)
    y_k, ops_k = xbar_mvm_pallas(jnp.asarray(a), jnp.asarray(w),
                                 jmake(**regs), interpret=True)
    y_t, ops_t = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w),
                          tmake(**regs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_k), atol=0)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_k))


def test_four_bit_slices_match_simulator(rng):
    a, w = _operands(rng, 4, 64, 4, k_i=4, k_w=4)
    regs = dict(delta_r1=1.0, n_r1=3, n_r2=5, m=1)
    cfg = JPimConfig(k_i=4, k_w=4)
    y_s, ops_s = jbit_exact(jnp.asarray(a), jnp.asarray(w), jmake(**regs),
                            cfg, with_ops=True)
    y_t, ops_t = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w),
                          tmake(**regs), k_i=4, k_w=4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_s), atol=0)
    assert int(ops_t.sum()) == float(ops_s)
    y_l, _ = xbar_mvm(torch.from_numpy(a), torch.from_numpy(w), None,
                      k_i=4, k_w=4)
    np.testing.assert_array_equal(y_l.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("k", [128, 300, 33])
def test_packing_round_trips_to_bitplanes(rng, k):
    a = torch.from_numpy(rng.integers(0, 256, (5, k)).astype(np.int32))
    masks = pack_planes(a, 8)
    g = -(-k // 128)
    assert masks.shape == (8, 5, g, 4) and masks.dtype == torch.int32
    planes = unpack_planes(masks).reshape(8, 5, g * 128)
    assert torch.equal(planes[..., :k], bitplanes(a, 8).float())
    assert not bool(planes[..., k:].any())
    # the weight layout: (bits, G, N, 4), one mask per column and group
    u = torch.from_numpy(rng.integers(0, 256, (k, 7)).astype(np.int32))
    wm = pack_weight_planes(u, 8)
    assert wm.shape == (8, g, 7, 4)
    assert torch.equal(wm.permute(0, 2, 1, 3), pack_planes(u.t(), 8))


def test_weight_packing_by_column_blocks(monkeypatch):
    """Programming packs a block of columns at a time: the masks equal the
    whole matrix packed at once, also with a ragged last block."""
    from repro_torch.kernels.xbar_mvm import ops
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, 256, (300, 10)).astype(np.int32))
    whole = pack_weight_planes(u, 8)
    monkeypatch.setattr(ops, "PACK_WEIGHTS", 4 * 300)
    assert torch.equal(pack_weight_planes(u, 8), whole)
    assert torch.equal(whole.permute(0, 2, 1, 3), pack_planes(u.t(), 8))


@pytest.mark.parametrize("k", [300, 1000])
def test_programming_blocks_hold_a_bounded_number_of_weights(monkeypatch,
                                                             k):
    """A packing block holds at most ``PACK_WEIGHTS`` weights whatever K
    is (whole columns, at least one): a block of a fixed number of columns
    took 32 GB of int64 temporaries at K = 28,672.  ``bit_exact_weights``
    programs block by block, so its temporaries are a block's too, and its
    scale, masks and column sums equal those of one whole-matrix pass."""
    from repro_torch.kernels.xbar_mvm import ops
    from repro_torch.pim.backend import bit_exact_weights
    from repro_torch.pim.crossbar import PimConfig
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.standard_normal((k, 50)).astype(np.float32))
    whole = bit_exact_weights(w, PimConfig())
    rows = []
    pack = ops.pack_planes

    def record(x, bits):
        rows.append(x.shape[0] * x.shape[1])
        return pack(x, bits)
    monkeypatch.setattr(ops, "pack_planes", record)
    monkeypatch.setattr(ops, "PACK_WEIGHTS", 5000)
    blocked = bit_exact_weights(w, PimConfig())
    assert max(rows) <= max(5000, k) and len(rows) == -(-50 // (5000 // k))
    for a, b in zip(blocked, whole):
        assert torch.equal(a, b)


def test_masks_in_ops_total_out(rng):
    """``xbar_mvm_2d`` is the kernel contract: masks in, the accumulator
    before the zero-point correction and the int64 op total out."""
    a, w = _operands(rng, 3, 200, 6)
    am = pack_planes(torch.from_numpy(a), 8)
    wm = pack_weight_planes(torch.from_numpy(w) + 128, 8)
    acc, total, per = xbar_mvm_2d(am, wm, None)
    assert per is None and total.dtype == torch.int64
    assert int(total) == 8 * 8 * 8 * 2 * 3 * 6
    want = a.astype(np.int64) @ (w.astype(np.int64) + 128)
    np.testing.assert_array_equal(acc.numpy(), want)


PLAN_SHAPES = [(m, k, n) for m in (1, 4, 5, 16, 17, 64, 2048)
               for k, n in ((3072, 3072), (3072, 1024), (3072, 8192),
                            (8192, 3072), (300, 130), (100, 40),
                            (16384, 512))]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_shape_plan_fills_the_card_within_the_budget(m, k, n, sms):
    """The CUDA kernel's shape rules (``kernel.plan``): 4-row blocks at
    decode batches, 8-row blocks above, 32 columns a block; the groups
    split among the largest power of two of a cluster's blocks (at most 8
    and G) that keeps one wave of 2 blocks an SM, or, when that split
    block's per-group partials pass the budget, the least larger split
    that fits, else none."""
    from repro_torch.kernels.xbar_mvm.kernel import (
        ACC_BUDGET, BLOCK_COLS, BLOCKS_PER_SM, plan)
    g = -(-k // 128)
    p = plan(m, g, n, 8, 8, sms)
    tm = 4 if m <= 4 else 8
    assert (p.body, p.tm, p.tn) == (f"tc{tm}", tm, BLOCK_COLS)
    tiles = -(-m // tm) * -(-n // BLOCK_COLS)

    def fits(s):
        return s == 1 or -(-g // s) * tm * BLOCK_COLS * 4 <= ACC_BUDGET
    splits = [s for s in (1, 2, 4, 8) if s <= max(1, g)]
    one_wave = max(s for s in splits
                   if s == 1 or tiles * s <= BLOCKS_PER_SM * sms)
    larger = [s for s in splits if s > one_wave and fits(s)]
    want = one_wave if fits(one_wave) else min(larger, default=1)
    assert p.split == want and p.blocks == tiles * want


def test_shape_plan_of_the_serving_shapes():
    """llama3.2-3b's projections on 132 SMs: (split, blocks) at decode
    (M = 4), continued prefill (16) and prefill (64), in the order wq/wo,
    wk/wv, w_gate/w_up, w_down."""
    from repro_torch.kernels.xbar_mvm.kernel import plan
    kn = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
    got = {m: [plan(m, k // 128, n, 8, 8, 132)[3:] for k, n in kn]
           for m in (4, 16, 64)}
    assert got == {4: [(2, 192), (8, 256), (1, 256), (2, 192)],
                   16: [(1, 192), (4, 256), (1, 512), (1, 192)],
                   64: [(1, 768), (1, 256), (1, 2048), (1, 768)]}


def test_shape_plan_names_the_general_body():
    from repro_torch.kernels.xbar_mvm.kernel import plan
    assert plan(4, 24, 1024, 8, 8, 132).body == "tc4"
    assert plan(4, 24, 1024, 4, 4, 132).body == "tc4_general"
    assert plan(16, 24, 1024, 8, 4, 132).body == "tc8_general"


def test_shape_plan_constants_match_the_cuda_source():
    """The plan's limits mirror the kernel's: columns a block (kTN),
    blocks a cluster (kMaxSplit), the partials budget (kAccBudget) and
    the blocks an SM of ``__launch_bounds__``, read from the ``.cu``."""
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.xbar_mvm import kernel as k3
    src = (build.CSRC / "xbar_mvm.cu").read_text()
    env: dict = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr, {}, dict(env))
    blocks = re.search(r"__launch_bounds__\(kThreads, (\d+)\)", src)
    assert (env["kTN"], env["kMaxSplit"], env["kAccBudget"]) == \
        (k3.BLOCK_COLS, k3.MAX_SPLIT, k3.ACC_BUDGET)
    assert blocks and int(blocks.group(1)) == k3.BLOCKS_PER_SM


def test_weight_stages_are_released_after_a_proxy_fence():
    """The kernel's consumer warps read each weight stage through the
    generic proxy and the producer refills it with a bulk copy (the async
    proxy): every release of a stage (``mbar_arrive(empty ...)``) follows
    a ``fence.proxy.async`` after the stage's last read, in the ``.cu``
    (the card test ``test_xbar_mvm_repeats_bit_for_bit_beside_other_work``
    shows the race the fence closes)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "xbar_mvm.cu").read_text()
    assert 'asm volatile("fence.proxy.async.shared::cta;"' in src
    releases = [m.start() for m in re.finditer(r"mbar_arrive\(empty", src)]
    assert releases
    for at in releases:
        window = src[max(0, at - 300):at]
        assert "fence_proxy_async();" in window
        assert "wt + c * kPlane" in src[max(0, at - 700):at]

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

"""Parity of the port's ``trq_group_mvm`` (per-128-row-group signed-TRQ
matmul with the fused A/D-op count) with the reference.

On the CPU the port's wrapper runs the kernel's plain version
(``kernels/trq_group_mvm/ref.py``); it is held against the reference Pallas
kernel in interpret mode (``trq_group_mvm_pallas(interpret=True)``) and
against ``repro.pim.crossbar.fake_quant_mvm``, on the shapes of
``tests/test_kernels.py``, at rtol=atol=1e-5 (the two sum each group's
128 products in different orders), and exactly (y and op totals) on
integer-valued inputs, where every f32 partial sum is exact.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.trq import make_params as jmake  # noqa: E402
from repro.kernels import trq_group_mvm_pallas  # noqa: E402
from repro.pim.backend import pallas_backend as jpallas  # noqa: E402
from repro.pim.crossbar import auto_range_fit_grouped as jfit  # noqa: E402
from repro.pim.crossbar import fake_quant_mvm as jfake  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.core.trq import auto_range_delta, trq_ad_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.trq_group_mvm import (pack_scalars,  # noqa: E402
                                               trq_group_mvm,
                                               trq_group_mvm_2d)
from repro_torch.kernels.trq_group_mvm.kernel import \
    trq_group_mvm_cuda  # noqa: E402
from repro_torch.kernels.trq_group_mvm.ref import \
    trq_group_mvm_ref  # noqa: E402
from repro_torch.pim.backend import pallas_backend as tpallas  # noqa: E402
from repro_torch.pim.crossbar import auto_range_fit as tfit  # noqa: E402
from repro_torch.pim.crossbar import auto_range_fit_grouped \
    as tfit_grouped  # noqa: E402
from repro_torch.pim.crossbar import fake_quant_mvm as tfake  # noqa: E402

PARAM_GRID = [
    dict(n_r1=4, n_r2=4, m=3, bias=0.0),
    dict(n_r1=2, n_r2=6, m=1, bias=0.0),
    dict(n_r1=3, n_r2=5, m=4, bias=3.0),
    dict(n_r1=7, n_r2=7, m=0, bias=0.0),
]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(21)


def _pair(**kw):
    return jmake(signed=True, **kw), tmake(signed=True, **kw)


def _port(a, w, p, a_scale, w_scale=1.0):
    y, ops = trq_group_mvm(torch.from_numpy(a), torch.from_numpy(w), p,
                           a_scale, w_scale, with_ops=True)
    return y.numpy(), int(ops)


def _ref(a, w, p, a_scale, w_scale=1.0):
    y, ops = trq_group_mvm_pallas(jnp.asarray(a), jnp.asarray(w), p, a_scale,
                                  w_scale, interpret=True, with_ops=True)
    return np.asarray(y), float(ops)


@pytest.mark.parametrize("m,k,n", [(100, 300, 130), (128, 128, 128),
                                   (1, 256, 64), (64, 512, 8)])
def test_group_mvm_matches_pallas_and_sim(rng, m, k, n):
    pj, pt = _pair(delta_r1=1.0, n_r1=4, n_r2=4, m=3)
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    y, ops = _port(a, w, pt, 0.05)
    y_ref, ops_ref = _ref(a, w, pj, 0.05)
    np.testing.assert_allclose(y, y_ref, **TOL)
    assert ops == ops_ref
    np.testing.assert_allclose(
        y, np.asarray(jfake(jnp.asarray(a), jnp.asarray(w), pj, 0.05, 1.0)),
        **TOL)


def test_group_mvm_batched_lead_dims(rng):
    pj, pt = _pair(delta_r1=1.0, n_r1=4, n_r2=6, m=2)
    a = rng.normal(0, 1, (2, 3, 256)).astype(np.float32)
    w = rng.normal(0, 1, (256, 32)).astype(np.float32)
    y, ops = _port(a, w, pt, 0.05)
    assert y.shape == (2, 3, 32)
    y_ref, ops_ref = _ref(a, w, pj, 0.05)
    np.testing.assert_allclose(y, y_ref, **TOL)
    assert ops == ops_ref


@pytest.mark.parametrize("pk", PARAM_GRID, ids=lambda d: "r{n_r1}-{n_r2}-m{m}-b{bias:g}".format(**d))
def test_group_mvm_param_sweep(rng, pk):
    pj, pt = _pair(delta_r1=1.0, **pk)
    a = rng.normal(0, 1, (32, 384)).astype(np.float32)
    w = rng.normal(0, 1, (384, 48)).astype(np.float32)
    y, ops = _port(a, w, pt, 0.1)
    y_ref, ops_ref = _ref(a, w, pj, 0.1)
    np.testing.assert_allclose(y, y_ref, **TOL)
    assert ops == ops_ref


@pytest.mark.parametrize("pk", PARAM_GRID, ids=lambda d: "r{n_r1}-{n_r2}-m{m}-b{bias:g}".format(**d))
@pytest.mark.parametrize("m,k,n", [(3, 300, 130), (8, 256, 64)])
def test_group_mvm_exact_on_integer_inputs(rng, pk, m, k, n):
    """Integer operands and a power-of-two grid: every partial sum, every
    quantizer step and the op total are exact, so port == reference
    bit for bit whatever the summation order."""
    pj, pt = _pair(delta_r1=2.0, **pk)
    a = rng.integers(-8, 9, (m, k)).astype(np.float32)
    w = rng.integers(-8, 9, (k, n)).astype(np.float32)
    y, ops = _port(a, w, pt, 0.5, 2.0)
    y_ref, ops_ref = _ref(a, w, pj, 0.5, 2.0)
    np.testing.assert_array_equal(y, y_ref)
    assert ops == ops_ref


def test_group_mvm_ops_cover_only_the_valid_region(rng):
    """Ragged M, K, N: padded rows and columns are zeros, which fall in R1
    and would add ops; the count covers exactly the M x N x G conversions."""
    pj, pt = _pair(delta_r1=1.0, n_r1=2, n_r2=6, m=1)
    m, k, n = 3, 300, 130
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    _, ops = _port(a, w, pt, 0.1)
    g = -(-k // 128)
    ap = np.zeros((m, g * 128), np.float32)
    ap[:, :k] = a
    wp = np.zeros((g * 128, n), np.float32)
    wp[:k] = w
    psum = torch.einsum("mgx,gxn->mgn",
                        torch.from_numpy(ap.reshape(m, g, 128)),
                        torch.from_numpy(wp.reshape(g, 128, n)))
    want = int(trq_ad_ops(psum / 0.1, pt).sum())
    assert ops == want
    assert ops == _ref(a, w, pj, 0.1)[1]
    # fewer than if every conversion of a padded 8 x 256 tile had counted
    assert ops < 8 * 256 * g * (pt.nu + pt.n_r2)


@pytest.mark.parametrize("auto_range", [False, True])
def test_fake_quant_mvm_matches_reference(rng, auto_range):
    pj, pt = _pair(delta_r1=1.0, n_r1=6, n_r2=6, m=4)
    a = rng.normal(0, 1, (5, 320)).astype(np.float32)
    w = rng.normal(0, 1, (320, 24)).astype(np.float32)
    yj, oj = jfake(jnp.asarray(a), jnp.asarray(w), pj, 0.02, 0.03,
                   auto_range=auto_range, with_ops=True)
    yt, ot = tfake(torch.from_numpy(a), torch.from_numpy(w), pt, 0.02, 0.03,
                   auto_range=auto_range, with_ops=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert int(ot) == float(oj)


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("m,k,n", [(3, 300, 130), (8, 256, 64),
                                   (1, 384, 32), (64, 512, 8)])
def test_fused_auto_range_matches_pallas_backend(rng, m, k, n, kind):
    """The plain version with the auto-range fit folded in, through the
    port's ``pallas`` backend, against the reference backend (pre-fit,
    then the Pallas kernel in interpret mode): on integer inputs with a
    power-of-two grid y and ops are equal bit for bit (the partial sums,
    hence their maximum and the register, are exact); on floats
    rtol=atol=1e-5 with ops equal."""
    pj, pt = _pair(delta_r1=1.0, n_r1=2, n_r2=6, m=1)
    if kind == "integer":
        a = rng.integers(-8, 9, (m, k)).astype(np.float32)
        w = rng.integers(-8, 9, (k, n)).astype(np.float32)
        scales = dict(a_scale=0.5, w_scale=2.0)
    else:
        a = rng.normal(0, 1, (m, k)).astype(np.float32)
        w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
        scales = {}
    yj, oj = jpallas(jnp.asarray(a), jnp.asarray(w), pj, auto_range=True,
                     interpret=True, **scales)
    yt, ot = tpallas(torch.from_numpy(a), torch.from_numpy(w), pt,
                     auto_range=True, **scales)
    if kind == "integer":
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    else:
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert int(ot) == float(oj)


@pytest.mark.parametrize("vmax", [0.0, 1e-9, 0.37, 5.0, 12345.678, 3.0e7])
def test_auto_range_register_bit_for_bit_at_equal_maxima(vmax):
    """The register the kernel and its plain version derive from a maximum
    (``auto_range_delta``) equals the reference's ``auto_range_fit_grouped``
    bit for bit when both see the same max |psum|: here a 1-row group whose
    only partial sum is ``vmax``."""
    for grid, regs in ((0.0173, dict(n_r1=6, n_r2=6, m=4)),
                       (3.0, dict(n_r1=2, n_r2=6, m=1))):
        pj, pt = _pair(delta_r1=0.7, **regs)
        a_g = np.full((1, 1), vmax, np.float32)
        w_g = np.ones((1, 1, 1), np.float32)
        want = np.float32(jfit(jnp.asarray(a_g), jnp.asarray(w_g), pj,
                               jnp.float32(grid)).delta_r1)
        got = auto_range_delta(pt.delta_r1, torch.tensor(vmax), grid,
                               pt.n_r2 + pt.m)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
        port = tfit_grouped(torch.from_numpy(a_g), torch.from_numpy(w_g), pt,
                            torch.tensor(grid, dtype=torch.float32))
        assert torch.equal(port.delta_r1, got)


def test_fused_fit_equals_the_pre_fit_then_fixed_registers(rng):
    """On the same partial sums the fused fit of the plain version and the
    separate pre-fit (``auto_range_fit``) followed by fixed registers give
    the same y and ops, bit for bit: one maximum, one register."""
    pt = tmake(delta_r1=1.0, n_r1=6, n_r2=6, m=4, signed=True)
    a = torch.from_numpy(rng.normal(0, 1, (5, 300)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (300, 40)).astype(np.float32))
    grid = torch.tensor(0.003)
    regs = dict(n_r1=6, n_r2=6, m=4)
    y_f, ops_f = trq_group_mvm_ref(a, w, pack_scalars(pt, grid, "cpu"),
                                   auto_range=True, **regs)
    fitted = tfit(a, w, pt, grid)
    y_p, ops_p = trq_group_mvm_ref(a, w, pack_scalars(fitted, grid, "cpu"),
                                   **regs)
    assert torch.equal(y_f, y_p) and int(ops_f) == int(ops_p)
    # bf16 weights go in as they are and are widened exactly
    wb = w.to(torch.bfloat16)
    y_b, ops_b = trq_group_mvm_ref(a, wb, pack_scalars(pt, grid, "cpu"),
                                   auto_range=True, **regs)
    y_w, ops_w = trq_group_mvm_ref(a, wb.float(),
                                   pack_scalars(pt, grid, "cpu"),
                                   auto_range=True, **regs)
    assert torch.equal(y_b, y_w) and int(ops_b) == int(ops_w)


def test_plain_version_accumulates_groups_in_order(rng):
    """ref.py sums the groups' quantized tiles one after another from zero,
    as the kernel's group loop does."""
    pt = tmake(delta_r1=1.0, n_r1=4, n_r2=4, m=3, signed=True)
    a = torch.from_numpy(rng.normal(0, 1, (4, 384)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (384, 16)).astype(np.float32))
    s = pack_scalars(pt, torch.tensor(0.1), "cpu")
    y, _ = trq_group_mvm_ref(a, w, s, n_r1=4, n_r2=4, m=3)
    acc = torch.zeros(4, 16)
    for g in range(3):
        sl = slice(128 * g, 128 * (g + 1))
        y_g, _ = trq_group_mvm_ref(a[:, sl], w[sl], s, n_r1=4, n_r2=4, m=3)
        acc = acc + y_g
    assert torch.equal(y, acc)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, 128)
    w = torch.zeros(128, 4)
    s = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        trq_group_mvm_cuda(a, w, s, n_r1=4, n_r2=4, m=3)
    # a meta tensor (no data: the dry run's shapes) takes the plain
    # version by an explicit device check; any other device has no kernel
    y, ops = trq_group_mvm_2d(a.to("meta"), w.to("meta"), s.to("meta"),
                              n_r1=4, n_r2=4, m=3)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 4)
    assert ops.device.type == "meta"
    from types import SimpleNamespace
    from repro_torch.kernels.build import route
    with pytest.raises(ValueError, match="no kernel"):
        route(SimpleNamespace(device=torch.device("xpu")))


def test_build_names_sources_and_flags():
    """The library name hashes the sources and flags; the flags target
    sm_90a and never enable fast math (the quantizer needs IEEE division)."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)
    assert (build.CSRC / "trq_group_mvm.cu").exists()
    assert (build.CSRC / "trq.cuh").exists()
    p = build._lib_path("trq_group_mvm")
    assert p.parent == build.BUILD_DIR and p.name.startswith(
        "libtrq_group_mvm-")
    # the wrapper allocates the launcher's stats words: the op total and
    # the auto-range maximum cells, two 32-bit cells to a word
    import re
    src = (build.CSRC / "trq_group_mvm.cu").read_text()
    cells = int(re.search(r"kMaxCells = (\d+);", src).group(1))
    from repro_torch.kernels.trq_group_mvm.kernel import STATS
    assert STATS == 1 + cells // 2


def test_tma_stages_are_released_after_a_proxy_fence():
    """The TMA body's consumer warps read each stage (weight and activation
    tiles) through the generic proxy and the producer refills it with a
    tensor copy (the async proxy): every release of a stage
    (``mbar_arrive(empty ...)``) follows a ``fence.proxy.async`` after the
    stage's last read, in the ``.cu`` (the card test
    ``test_trq_group_mvm_tma_repeats_bit_for_bit_beside_other_work``
    stresses the release)."""
    import re
    src = (build.CSRC / "trq_group_mvm.cu").read_text()
    assert 'asm volatile("fence.proxy.async.shared::cta;"' in src
    releases = [m.start() for m in re.finditer(r"mbar_arrive\(empty", src)]
    assert len(releases) == 1
    for at in releases:
        window = src[max(0, at - 400):at]
        assert "fence_proxy_async();" in window
        assert "the stage's last read" in window
        assert "Weights<true>::widen(raw[i], wf)" in src[max(0, at - 1200):at]

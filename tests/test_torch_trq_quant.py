"""Parity of the port's ``trq_quant`` (K2) with the reference Pallas kernel
``repro.kernels.trq_quant_pallas`` (interpret mode on the CPU).

On a CPU tensor the port's wrapper runs the kernel's plain version
(``kernels/trq_quant/ref.py``); the CUDA kernel itself is held against that
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 5).  Bars are the reference's own (``tests/test_kernels.py``): q at
``atol=0`` with op counts equal, f16 input at ``atol=1e-3``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.trq import make_params as jmake  # noqa: E402
from repro.kernels import trq_quant_pallas  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.core.trq import trq_ad_ops, trq_quant  # noqa: E402
from repro_torch.kernels.trq_quant import trq_quant as k2  # noqa: E402
from repro_torch.kernels.trq_quant.ref import trq_quant_ref  # noqa: E402

PARAM_GRID = [
    dict(n_r1=4, n_r2=4, m=3, bias=0.0),
    dict(n_r1=2, n_r2=6, m=1, bias=0.0),
    dict(n_r1=3, n_r2=5, m=4, bias=3.0),
    dict(n_r1=7, n_r2=7, m=0, bias=0.0),
]
SHAPES = [(8,), (100, 130), (3, 5, 7), (256, 256), (1, 1)]
MODES = [dict(signed=True), dict(signed=False),
         dict(signed=True, mode="uniform"), dict(signed=False, mode="uniform")]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(41)


@pytest.mark.parametrize("mode", MODES, ids=["signed", "unsigned",
                                             "uniform-signed", "uniform"])
@pytest.mark.parametrize("pk", PARAM_GRID, ids=["4-4", "2-6", "3-5-b3",
                                                "7-7"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_k2_matches_pallas_kernel(rng, shape, pk, mode):
    x = rng.normal(0, 30, shape).astype(np.float32)
    if not mode["signed"]:
        x = np.abs(x) * np.where(rng.random(shape) < 0.1, -1, 1)
    delta = 1.0 if pk["bias"] == 0.0 else 0.7
    q_j, ops_j = trq_quant_pallas(jnp.asarray(x),
                                  jmake(delta_r1=delta, **pk, **mode),
                                  interpret=True)
    q_t, ops_t = k2(torch.from_numpy(x), tmake(delta_r1=delta, **pk, **mode))
    assert q_t.shape == x.shape and q_t.dtype == torch.float32
    assert ops_t.dtype == torch.int32
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=0)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_k2_dtypes(rng, dtype):
    x = rng.normal(0, 30, (64, 64)).astype(dtype)
    q_j, ops_j = trq_quant_pallas(
        jnp.asarray(x), jmake(delta_r1=1.0, n_r1=4, n_r2=4, m=3,
                              signed=True), interpret=True)
    q_t, ops_t = k2(torch.from_numpy(x),
                    tmake(delta_r1=1.0, n_r1=4, n_r2=4, m=3, signed=True))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-3)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))


def test_ref_is_the_core_quantizer(rng):
    """The plain version is ``core.trq`` on the whole tensor, with the
    registers taken from the kernel's [delta_r1, bias] operand."""
    p = tmake(delta_r1=0.35, bias=2.0, n_r1=4, n_r2=5, m=2, signed=True)
    x = torch.from_numpy(rng.normal(0, 20, (32, 33)).astype(np.float32))
    q, ops = trq_quant_ref(x, torch.tensor([0.35, 2.0]), n_r1=4, n_r2=5,
                           m=2, signed=True)
    assert torch.equal(q, trq_quant(x, p))
    assert torch.equal(ops, trq_ad_ops(x, p))


def test_k2_takes_bf16_and_rejects_other_devices(rng):
    p = tmake(delta_r1=1.0, n_r1=4, n_r2=4, m=3, signed=True)
    x = torch.from_numpy(rng.normal(0, 30, (16, 8)).astype(np.float32))
    q_b, _ = k2(x.bfloat16(), p)
    q_f, _ = k2(x.bfloat16().float(), p)
    assert torch.equal(q_b, q_f)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        k2(torch.empty(4, device="meta"), p)

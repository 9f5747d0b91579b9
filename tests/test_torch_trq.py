"""Parity of the port's TRQ quantizer (``repro_torch.core.trq``) with the
reference ``repro.core.trq``: the same numpy inputs through both, quantized
values equal at ``atol=0`` and per-conversion SAR-op counts equal, over the
register grid of ``tests/test_kernels.py`` in twin, uniform and signed
modes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import trq as jtrq  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import trq as ttrq  # noqa: E402

# the register grid of tests/test_kernels.py::PARAM_GRID
PARAM_GRID = [
    dict(n_r1=4, n_r2=4, m=3, bias=0.0),
    dict(n_r1=2, n_r2=6, m=1, bias=0.0),
    dict(n_r1=3, n_r2=5, m=4, bias=3.0),
    dict(n_r1=7, n_r2=7, m=0, bias=0.0),
]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def _both(delta_r1, **kw):
    return (jtrq.make_params(delta_r1=delta_r1, **kw),
            ttrq.make_params(delta_r1=delta_r1, **kw))


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("mode", ["twin", "uniform"])
@pytest.mark.parametrize("pk", PARAM_GRID, ids=lambda d: "r{n_r1}-{n_r2}-m{m}-b{bias:g}".format(**d))
def test_trq_quant_and_ops_match_reference(rng, pk, mode, signed):
    # a non-power-of-two step exercises the correctly rounded division
    pj, pt = _both(0.37, mode=mode, signed=signed, **pk)
    x = rng.normal(0, 40, (64, 33)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    q_j = np.asarray(jtrq.trq_quant(jnp.asarray(x), pj))
    q_t = ttrq.trq_quant(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=0)
    ops_j = np.asarray(jtrq.trq_ad_ops(jnp.asarray(x), pj))
    ops_t = ttrq.trq_ad_ops(torch.from_numpy(x), pt).numpy()
    np.testing.assert_array_equal(ops_t, ops_j)
    assert ops_t.dtype == np.int32


def test_uniform_code_rounds_half_away_from_zero():
    """``floor(x/delta + 0.5)``: ties go up (torch.round would go to even)."""
    x = torch.tensor([0.5, 1.5, 2.5, 3.49, 100.0, -3.0])
    code = ttrq.uniform_code(x, 1.0, 4).tolist()
    assert code == [1, 2, 3, 3, 15, 0]
    want = np.asarray(jtrq.uniform_code(jnp.asarray(x.numpy()), 1.0, 4))
    assert code == want.tolist()


def test_trq_hits_r1_edges_like_reference():
    """Values on the R1 edges (offset and theta) and the sign of zero."""
    pj, pt = _both(0.5, bias=2.0, n_r1=3, n_r2=5, m=2, signed=True)
    off, th = float(pt.offset), float(pt.theta)
    x = np.array([0.0, -0.0, off, -off, th, -th, np.nextafter(th, 0),
                  np.nextafter(off, 0)], np.float32)
    np.testing.assert_array_equal(
        ttrq.trq_quant(torch.from_numpy(x), pt).numpy(),
        np.asarray(jtrq.trq_quant(jnp.asarray(x), pj)))
    np.testing.assert_array_equal(
        ttrq.trq_ad_ops(torch.from_numpy(x), pt).numpy(),
        np.asarray(jtrq.trq_ad_ops(jnp.asarray(x), pj)))


def test_trq_quant_ste_forward_and_identity_gradient(rng):
    _, pt = _both(1.0, n_r1=4, n_r2=4, m=3, signed=True)
    x = torch.from_numpy(rng.normal(0, 30, (16,)).astype(np.float32))
    x.requires_grad_(True)
    y = ttrq.trq_quant_ste(x, pt)
    assert torch.equal(y.detach(), ttrq.trq_quant(x.detach(), pt))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_adc_energy_matches_reference():
    from repro.core.energy import E_OP_PJ, adc_energy_pj
    assert tenergy.E_OP_PJ == E_OP_PJ
    assert tenergy.adc_energy_pj(93184) == float(adc_energy_pj(93184))

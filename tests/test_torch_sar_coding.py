"""Parity of the port's SAR-ADC behavioral model, output coding and energy
reports (``repro_torch.core.sar_adc``/``coding``/``energy``) with the
reference (``repro.core.sar_adc``/``coding``/``energy``).

The same voltages go to both: a grid that holds every comparator
threshold ``(idx - 1/2) * lsb`` and the R1 edges, each with its f32
neighbours, plus values below zero and past the top code.  Codes and op
counts must be equal.  The cycle-accurate search and the closed form
differ one ulp below a threshold in both packages (``floor(v / lsb +
0.5)`` rounds ``0.49999997 + 0.5`` up to 1 in f32, where the comparator
keeps 0); everywhere else on an exact grid (``lsb`` a power of two) they
are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import coding as jcoding  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import sar_adc as jsar  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro_torch.core import coding as tcoding  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import sar_adc as tsar  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402

# (delta_r1, bias, n_r1, n_r2, m): R1 at 0 and offset, fine and coarse
# widths, a fractional step
REGS = [(1.0, 0.0, 4, 4, 3), (1.0, 2.0, 3, 5, 2), (0.75, 1.0, 2, 6, 1),
        (2.0, 0.0, 1, 3, 4)]


def _with_neighbours(v) -> np.ndarray:
    """``v`` and its f32 neighbours, without subnormals (XLA on the CPU
    flushes them to zero, torch does not; a bit-line sum is an integer)."""
    v = np.asarray(v, np.float32)
    v = np.unique(np.concatenate([
        v, np.nextafter(v, np.float32(-np.inf)),
        np.nextafter(v, np.float32(np.inf))]))
    return v[(v == 0) | (np.abs(v) >= np.finfo(np.float32).tiny)]


def _grid(lsb: float, k: int) -> np.ndarray:
    """Every threshold of a k-bit search at ``lsb`` (f32, as the search
    forms it) and its neighbours, below-zero and above-range values."""
    idx = np.arange(2 ** k + 1, dtype=np.float32)
    th = (idx - np.float32(0.5)) * np.float32(lsb)
    extra = np.float32([-3.0, -0.1, 0.0, 1e-3, (2 ** k + 3) * lsb, 1e4])
    return _with_neighbours(np.concatenate([th, extra]))


def _trq_grid(p: tuple) -> np.ndarray:
    delta, bias, n_r1, n_r2, m = p
    d1 = np.float32(delta)
    offset = np.float32(bias) * np.float32(2.0 ** n_r1) * d1
    parts = [offset + _grid(d1, n_r1), _grid(d1 * np.float32(2.0 ** m),
                                             n_r2),
             [offset, offset + np.float32(2.0 ** n_r1) * d1]]
    return _with_neighbours(np.concatenate(parts).astype(np.float32))


def _pair(p: tuple):
    delta, bias, n_r1, n_r2, m = p
    kw = dict(delta_r1=delta, bias=bias, n_r1=n_r1, n_r2=n_r2, m=m)
    return jmake(**kw), tmake(**kw)


@pytest.mark.parametrize("k,lsb", [(1, 1.0), (4, 1.0), (8, 1.0), (3, 0.7),
                                   (5, 2.5)])
def test_sar_uniform_matches_reference_at_every_threshold(k, lsb):
    v = _grid(lsb, k)
    code_s, ops_s = tsar.sar_search_uniform(torch.from_numpy(v), k, lsb)
    code_c, ops_c = tsar.sar_convert_uniform(torch.from_numpy(v), k, lsb)
    jcode_s, jops_s = jsar.sar_search_uniform(jnp.asarray(v), k, lsb)
    jcode_c, jops_c = jsar.sar_convert_uniform(jnp.asarray(v), k, lsb)
    np.testing.assert_array_equal(code_s.numpy(), np.asarray(jcode_s))
    np.testing.assert_array_equal(code_c.numpy(), np.asarray(jcode_c))
    for ops in (ops_s, ops_c):
        assert ops.dtype == torch.int32 and bool((ops == k).all())
    np.testing.assert_array_equal(ops_s.numpy(), np.asarray(jops_s))
    np.testing.assert_array_equal(ops_c.numpy(), np.asarray(jops_c))
    if lsb == 1.0:              # exact grid: the search is the closed form
        off = code_s != code_c
        assert torch.equal(code_s[off] + 1, code_c[off])
        assert bool((torch.from_numpy(v)[off] % 1.0 < 0.5).all())
    assert int(code_s.min()) == 0 and int(code_s.max()) == 2 ** k - 1


@pytest.mark.parametrize("p", REGS, ids=lambda p: "-".join(map(str, p)))
def test_sar_trq_matches_reference_at_every_threshold(p):
    jp, tp = _pair(p)
    v = _trq_grid(p)
    got_s = tsar.sar_search_trq(torch.from_numpy(v), tp)
    got_c = tsar.sar_convert_trq(torch.from_numpy(v), tp)
    want_s = jsar.sar_search_trq(jnp.asarray(v), jp)
    want_c = jsar.sar_convert_trq(jnp.asarray(v), jp)
    for got, want in ((got_s, want_s), (got_c, want_c)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(got_s[0], got_c[0]) and torch.equal(got_s[2],
                                                            got_c[2])
    msb = got_c[0]
    assert bool((msb == 0).any()) and bool((msb == 1).any())


@pytest.mark.parametrize("p", REGS, ids=lambda p: "-".join(map(str, p)))
def test_coding_matches_reference(p):
    jp, tp = _pair(p)
    v = _trq_grid(p)
    code = tcoding.encode(torch.from_numpy(v), tp)
    jcode = jcoding.encode(jnp.asarray(v), jp)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    assert tcoding.code_bits(tp) == jcoding.code_bits(jp)
    assert tcoding.payload_bits(tp) == jcoding.payload_bits(jp)
    assert int(code.max()) < 2 ** tcoding.code_bits(tp)
    for g, w in zip(tcoding.split(code, tp), jcoding.split(jcode, jp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx = tcoding.decode_index(code, tp)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jcoding.decode_index(jcode, jp)))
    np.testing.assert_array_equal(tcoding.decode(code, tp).numpy(),
                                  np.asarray(jcoding.decode(jcode, jp)))
    acc = torch.arange(v.size, dtype=torch.int32)
    for shift in (0, 3, 7):
        np.testing.assert_array_equal(
            tcoding.shift_add(acc, code, tp, shift).numpy(),
            np.asarray(jcoding.shift_add(jnp.asarray(acc.numpy()), jcode, jp,
                                         shift)))


def test_energy_reports_match_reference():
    rng = np.random.default_rng(61)
    ys = {"conv0": np.round(np.abs(rng.normal(0, 3, 4096))),
          "conv3": np.round(rng.uniform(0, 60, 4096)),
          "fc7": np.round(np.abs(rng.normal(20, 4, 4096)))}
    regs = {"conv0": (1.0, 0.0, 4, 4, 3), "conv3": (0.75, 1.0, 2, 6, 1),
            "fc7": (1.0, 2.0, 3, 5, 2)}
    shapes = {"conv0": (25, 6, 784), "conv3": (150, 16, 100),
              "fc7": (400, 120, 1)}
    got, want = {}, {}
    for name, y in ys.items():
        jp, tp = _pair(regs[name])
        k, n, mvms = shapes[name]
        got[name] = tenergy.layer_report(name, k, n, mvms,
                                         torch.tensor(y, dtype=torch.float32),
                                         tp)
        want[name] = jenergy.layer_report(name, k, n, mvms,
                                          jnp.asarray(y, jnp.float32), jp)
        g, w = got[name], want[name]
        assert (g.name, g.conversions) == (w.name, w.conversions)
        assert isinstance(g.energy_trq_pj, float)
        np.testing.assert_allclose(
            [g.mean_ops_uniform, g.mean_ops_trq, g.energy_uniform_pj,
             g.energy_trq_pj, g.ratio],
            [w.mean_ops_uniform, w.mean_ops_trq, w.energy_uniform_pj,
             w.energy_trq_pj, w.ratio], rtol=1e-6)
    ratio = tenergy.model_adc_ratio(got)
    np.testing.assert_allclose(ratio, jenergy.model_adc_ratio(want),
                               rtol=1e-6)
    assert tenergy.POWER_SHARES == jenergy.POWER_SHARES
    for r in (ratio, 0.5, 1.0):
        g = tenergy.system_power_breakdown(r)
        w = jenergy.system_power_breakdown(r)
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-6)
    assert tenergy.system_power_breakdown(1.0)["total"] == pytest.approx(1.0)


def test_layer_report_is_a_dataclass_like_the_reference():
    fields = [f.name for f in dataclasses.fields(tenergy.LayerEnergyReport)]
    assert fields == [f.name for f in
                      dataclasses.fields(jenergy.LayerEnergyReport)]

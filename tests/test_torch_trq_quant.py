"""Parity of the port's ``trq_quant`` (K2) with the reference Pallas kernel
``repro.kernels.trq_quant_pallas`` (interpret mode on the CPU).

On a CPU tensor the port's wrapper runs the kernel's plain version
(``kernels/trq_quant/ref.py``); the CUDA kernel itself is held against that
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 5).  Bars are the reference's own (``tests/test_kernels.py``): q at
``atol=0`` with op counts equal, f16 input at ``atol=1e-3``.

The scoring entry (``trq_score``) is held to the elementwise route: its op
sums exactly, its squared-error sums bitwise against an f64 sum of the
elementwise f32 errors, and on integer samples with integral steps against
numpy's exact int64 sums.

``core.trq``'s ``trq_quant_with_ops``, ``quant_mse`` and ``ideal_params``
and ``data.synthetic.lm_batch`` are held to the reference's on the same
inputs: values and op counts exactly, the mean square at rtol 1e-6 (the
two means sum in another order), and ``lm_batch``, whose reference draws
from ``jax.random`` (numpy cannot replay it), on its layout, its bigram
map exactly and its two draws' shares within 0.05.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import trq as jtrq  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import trq as ttrq  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro.kernels import trq_quant_pallas  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.core.trq import trq_ad_ops, trq_quant  # noqa: E402
from repro_torch.kernels.trq_quant import score_table, trq_score  # noqa: E402
from repro_torch.kernels.trq_quant import trq_quant as k2  # noqa: E402
from repro_torch.kernels.trq_quant import kernel as k2_kernel  # noqa: E402
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
    # a meta tensor (no data: the dry run's shapes) takes the plain
    # version by an explicit device check; any other device has no kernel
    q_m, ops_m = k2(torch.empty(4, device="meta"), p)
    assert q_m.device.type == ops_m.device.type == "meta"
    from types import SimpleNamespace
    from repro_torch.kernels.build import route
    with pytest.raises(ValueError, match="no kernel for tensors on xpu"):
        route(SimpleNamespace(device=torch.device("xpu")))


# ---------------------------------------------------------------------------
# the scoring entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("delta", [1.0, 0.7])
@pytest.mark.parametrize("mode", MODES, ids=["signed", "unsigned",
                                             "uniform-signed", "uniform"])
@pytest.mark.parametrize("pk", PARAM_GRID, ids=["4-4", "2-6", "3-5-b3",
                                                "7-7"])
def test_score_equals_the_elementwise_route(pk, mode, delta, dtype):
    rng = np.random.default_rng(7)
    y = rng.normal(0, 30, 4099)
    if not mode["signed"]:
        y = np.abs(y) * np.where(rng.random(y.shape) < 0.1, -1, 1)
    y = torch.from_numpy(y.astype(dtype))
    p = tmake(delta_r1=delta, **pk, **mode)
    # the candidate between two others: a row of the table is its own
    table = [tmake(delta_r1=0.3, n_r1=2, n_r2=3, m=1), p,
             tmake(delta_r1=2.5, n_r1=5, n_r2=5, m=0, mode="uniform")]
    sq, ops = trq_score(y, *score_table(table))
    assert sq.dtype == torch.float64 and ops.dtype == torch.int64
    assert sq.shape == ops.shape == (3,)
    q, o = k2(y, p)
    want = torch.sum((q - y.float()).square(), dtype=torch.float64)
    assert torch.equal(sq[1], want)
    assert int(ops[1]) == int(o.sum(dtype=torch.int64))


@pytest.mark.parametrize("signed", [False, True])
def test_score_sums_are_exact_on_integer_samples(signed):
    """Integer samples, integral steps: every squared error is an integer
    below 2^15, so the f64 sums equal numpy's int64 sums, in any order."""
    rng = np.random.default_rng(8)
    y = rng.binomial(128, 0.25, 65536).astype(np.int64)
    if signed:
        y = y * np.where(rng.random(y.shape) < 0.5, -1, 1)
    table = [tmake(delta_r1=1.0, signed=signed, **pk, **mode)
             for pk in PARAM_GRID for mode in (dict(), dict(mode="uniform"))]
    sq, ops = trq_score(torch.from_numpy(y.astype(np.float32)),
                        *score_table(table))
    for i, p in enumerate(table):
        q, o = k2(torch.from_numpy(y.astype(np.float32)), p)
        qi = q.numpy().astype(np.int64)
        assert np.array_equal(qi, q.numpy())          # integral grid
        assert float(sq[i]) == float(np.sum((qi - y) ** 2))
        assert int(ops[i]) == int(np.sum(o.numpy().astype(np.int64)))


@pytest.mark.parametrize("case", ["width", "mode", "devices"])
def test_score_table_refuses_what_the_kernel_does_not_take(case):
    y = torch.zeros(16)
    if case == "width":
        with pytest.raises(ValueError, match="out of range"):
            score_table([tmake(n_r1=25, n_r2=4, m=3)])
    elif case == "mode":
        with pytest.raises(ValueError, match="unknown mode"):
            score_table([tmake(n_r1=4, n_r2=4, m=3, mode="log")])
    else:
        fregs, iregs = score_table([tmake(n_r1=4, n_r2=4, m=3)])
        with pytest.raises(ValueError, match="mixed devices"):
            trq_score(y, fregs.to("meta"), iregs)


def test_score_slice_matches_the_source():
    """The wrapper sizes the scratch by ``SCORE_SLICE`` samples a block:
    the source's ``kScoreThreads * kScorePer`` (the launcher refuses any
    other size)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "trq_quant.cu").read_text()
    val = {k: int(v) for k, v in re.findall(
        r"constexpr int (kScore\w+) = (\d+);", src)}
    assert k2_kernel.SCORE_SLICE == val["kScoreThreads"] * val["kScorePer"]


# ---------------------------------------------------------------------------
# the core's fused pair, the Eq. 10 error, the Eq. 11 registers, lm_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=["signed", "unsigned",
                                             "uniform-signed", "uniform"])
@pytest.mark.parametrize("pk", PARAM_GRID, ids=["4-4", "2-6", "3-5-b3",
                                                "7-7"])
def test_trq_quant_with_ops_and_quant_mse_match_reference(rng, pk, mode):
    x = rng.normal(0, 30, (37, 41)).astype(np.float32)
    if not mode["signed"]:
        x = (np.abs(x) * np.where(rng.random(x.shape) < 0.1, -1, 1)
             ).astype(np.float32)
    delta = 1.0 if pk["bias"] == 0.0 else 0.7
    jp, tp = jmake(delta_r1=delta, **pk, **mode), \
        tmake(delta_r1=delta, **pk, **mode)
    q_j, ops_j = jtrq.trq_quant_with_ops(jnp.asarray(x), jp)
    q_t, ops_t = ttrq.trq_quant_with_ops(torch.from_numpy(x), tp)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))
    assert ops_t.dtype == torch.int32
    e_j = float(jtrq.quant_mse(jnp.asarray(x), jp))
    e_t = ttrq.quant_mse(torch.from_numpy(x), tp)
    assert e_t.dtype == torch.float32 and e_t.ndim == 0
    np.testing.assert_allclose(float(e_t), e_j, rtol=1e-6)


@pytest.mark.parametrize("r_ideal", [1, 3, 7, 8, 12])
@pytest.mark.parametrize("n", [(2, 4), (4, 4), (3, 6), (7, 7)], ids=str)
def test_ideal_params_match_reference(rng, r_ideal, n):
    jp = jtrq.ideal_params(r_ideal=r_ideal, n_r1=n[0], n_r2=n[1])
    tp = ttrq.ideal_params(r_ideal=r_ideal, n_r1=n[0], n_r2=n[1])
    for f in ("n_r1", "n_r2", "m", "nu", "mode", "signed"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("delta_r1", "bias", "theta", "delta_r2"):
        assert float(getattr(tp, f)) == float(getattr(jp, f)), f
    # the lossless range of Eq. 11 quantizes the same, to the same error
    x = np.round(rng.uniform(0, 2.0 ** r_ideal - 1, 257)).astype(np.float32)
    np.testing.assert_array_equal(
        ttrq.trq_quant(torch.from_numpy(x), tp).numpy(),
        np.asarray(jtrq.trq_quant(jnp.asarray(x), jp)))
    np.testing.assert_allclose(float(ttrq.quant_mse(torch.from_numpy(x), tp)),
                               float(jtrq.quant_mse(jnp.asarray(x), jp)),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 3])
def test_lm_batch_matches_reference_stream(step):
    vocab, seq, batch, seed = 512, 64, 32, 1
    b_j = jsyn.lm_batch(vocab, seq, batch, step=step, seed=seed)
    b_t = tsyn.lm_batch(vocab, seq, batch, step=step, seed=seed,
                        device="cpu")
    assert torch.equal(b_t["tokens"], tsyn.TokenStream(
        vocab, seq, batch, seed).batch_at(step, device="cpu")["tokens"])
    bmap = tsyn.TokenStream(vocab, seq, batch, seed)._bigram_map()
    np.testing.assert_array_equal(
        bmap, jsyn.TokenStream(vocab, seq, batch, seed)._bigram_map())
    shares = []
    for b, tok, lab in ((b_j, np.asarray(b_j["tokens"]),
                         np.asarray(b_j["labels"])),
                        (b_t, b_t["tokens"].numpy(), b_t["labels"].numpy())):
        assert set(b) == {"tokens", "labels"}
        assert tok.shape == lab.shape == (batch, seq)
        assert tok.dtype == lab.dtype == np.int32
        assert 0 <= tok.min() and tok.max() < vocab
        np.testing.assert_array_equal(tok[:, 1:], lab[:, :-1])
        # the bigram share, and the Zipf-like unigram draw's head
        shares.append((np.mean(lab == bmap[tok]), np.mean(tok < 16)))
    np.testing.assert_allclose(shares[0], shares[1], atol=0.05)

"""Parity of the port's paper-evaluation path with the reference: the
synthetic vision data, im2col and the conv/FC mapping, the CNNs' float
forward, PTQ, the bit-exact PIM forward through ``xbar_mvm`` (its plain
version on the CPU), the conversion counts, one training step and
Algorithm 1 on the CNN's bit-line samples.

The same parameters go to both packages: a seeded numpy He-normal draw in
the reference's flat layout (``conv{li}``/``fc{li}``/``proj{li}``, HWIO
and (K, N)), handed to the port through ``convert.cnn_from_jax``.  Small
sizes: LeNet-5 at 28 x 28 and ResNet-20 at 8 x 8, two images.

The reference's PIM forward is recorded layer by layer (its module's
``conv2d_pim``/``bit_exact_mvm`` and the bit-line collectors wrapped for
the test, each under ``jax.jit``: the datapath is integer-valued and every
register set here quantizes with one multiply or on an integral step, so
jit and eager give the same bits, at half the compile time), so each of
the port's layers is held bit for bit to the reference on the reference's
own quantized layer input; the whole network is held within f32 tolerance,
since pooling and the global mean may sum in another order and move a
requantized code by a half step.  Bit-exact outputs equal the reference's
while every partial sum is exact: K3 sums in the Pallas kernel's order,
the reference in one einsum.  So a layer is bitwise equal below 2^24 units
of its register grid (integral or dyadic steps; the tests assert that
precondition), and on a calibrated fractional step (Algorithm 1's V_grid
uniform fallback) within the rounding of the two orders: k_i k_w G f32
ulps of the sum, whose terms are all nonnegative.
"""
import contextlib
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.calibrate import calibrate_layer as jcalibrate  # noqa: E402
from repro.core.trq import make_params as jmake  # noqa: E402
from repro.data.synthetic import vision_dataset as jvision  # noqa: E402
from repro.models import cnn as J  # noqa: E402
from repro.pim import crossbar as jxbar  # noqa: E402
from repro.pim import mapping as jmap  # noqa: E402
from repro_torch.convert import cnn_from_jax  # noqa: E402
from repro_torch.core.calibrate import calibrate_layer  # noqa: E402
from repro_torch.core.trq import make_params as tmake  # noqa: E402
from repro_torch.data.synthetic import vision_dataset  # noqa: E402
from repro_torch.models import cnn as T  # noqa: E402
from repro_torch.pim import mapping as tmap  # noqa: E402

NOISE = 0.8
N_IMG = 2
MODELS = {"lenet5": (J.LENET5, T.LENET5),
          "resnet20": (dataclasses.replace(J.RESNET20, input_hw=8),
                       dataclasses.replace(T.RESNET20, input_hw=8))}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread.  The plain scoring version
    runs a few thousand small ops a layer; on a CPU that other test
    processes oversubscribe, each op's OpenMP barrier waits for threads
    that are not scheduled, and a 2 s calibration takes many minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(spec, seed: int) -> dict:
    """He-normal weights, small random biases, in the reference's flat
    layout (the walk of ``repro.models.cnn.init_cnn``)."""
    rng = np.random.default_rng(seed)

    def leaf(shape, fan_in):
        w = rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        b = rng.normal(0, 0.05, shape[-1]).astype(np.float32)
        return {"w": w, "b": b}

    params = {}
    for li, l in enumerate(spec.layers):
        if l[0] == "conv":
            params[f"conv{li}"] = leaf((l[1], l[1], l[2], l[3]),
                                       l[1] * l[1] * l[2])
        elif l[0] == "fc":
            params[f"fc{li}"] = leaf((l[1], l[2]), l[1])
        elif l[0] == "res_end" and (l[1] != l[2] or l[3] != 1):
            params[f"proj{li}"] = leaf((1, 1, l[1], l[2]), l[1])
    return params


_JCONV = jax.jit(jmap.conv2d_pim,
                 static_argnames=("stride", "pad", "cfg", "with_ops"))
_JMVM = jax.jit(jxbar.bit_exact_mvm, static_argnames=("cfg", "with_ops"))
_JCONV_BL = jax.jit(jmap.conv2d_bl_samples,
                    static_argnames=("stride", "pad", "cfg"))
_JBL = jax.jit(jxbar.collect_bl_samples, static_argnames=("cfg",))


@contextlib.contextmanager
def _recording(layers: list):
    """Run the reference's PIM layers jitted and record them in call order:
    (quantized input, output before the zero-point correction, f32 op
    total)."""
    saved = (J.conv2d_pim, J.bit_exact_mvm, J.conv2d_bl_samples,
             jxbar.collect_bl_samples)

    def conv_rec(xq, w, trq, **kw):
        out, ops = _JCONV(xq, w, trq, **kw)
        layers.append((np.asarray(xq), np.asarray(out), float(ops)))
        return out, ops

    def mvm_rec(xq, w, trq, cfg, with_ops=False):
        out, ops = _JMVM(xq, w, trq, cfg, with_ops=True)
        layers.append((np.asarray(xq), np.asarray(out), float(ops)))
        return out, ops

    J.conv2d_pim, J.bit_exact_mvm = conv_rec, mvm_rec
    J.conv2d_bl_samples = _JCONV_BL
    jxbar.collect_bl_samples = lambda a, w, cfg: _JBL(a, w, cfg)
    try:
        yield layers
    finally:
        (J.conv2d_pim, J.bit_exact_mvm, J.conv2d_bl_samples,
         jxbar.collect_bl_samples) = saved


class Case:
    """One model: the same parameters and images in both packages, each
    package's PTQ model, and the reference's recorded lossless forward."""

    def __init__(self, name: str, seed: int, tap: bool = False):
        self.name = name
        self.spec_j, self.spec_t = MODELS[name]
        spec = self.spec_j
        self.p_np = _np_params(spec, seed)
        self.pj = jax.tree.map(jnp.asarray, self.p_np)
        self.pt = cnn_from_jax(self.p_np)
        x, _ = vision_dataset(4, hw=spec.input_hw, ch=spec.in_ch, seed=seed,
                              noise=NOISE, device="cpu")
        self.x_np = x.numpy()
        self.xj, self.xt = jnp.asarray(self.x_np), x
        self.qj = J.quantize_cnn(self.pj, spec, self.xj)
        self.qt = T.quantize_cnn(self.pt, self.spec_t, self.xt)
        # the reference's Fig. 6 samples: each layer's sums raveled in C order
        self.samples = {}
        self.lossless = self.run_ref(None, tap=(lambda n, s: self.samples.
                                                __setitem__(n, np.asarray(
                                                    s).ravel())) if tap
                                     else None)

    def run_ref(self, trq, tap=None):
        layers = []
        with _recording(layers):
            logits, ops = J.pim_forward(self.qj, self.xj[:N_IMG], trq,
                                        with_ops=True, tap_bl=tap)
        return np.asarray(logits), float(ops), layers


@pytest.fixture(scope="module")
def lenet():
    return Case("lenet5", 3, tap=True)


@pytest.fixture(scope="module")
def resnet():
    return Case("resnet20", 4)


# twin registers on the two convs' integer bit-line grid (R1 at 0, and
# offset by a bias), beside the calibrated registers of the other layers
TWIN = {"conv0": dict(delta_r1=1.0, bias=0.0, n_r1=4, n_r2=4, m=3),
        "conv3": dict(delta_r1=1.0, bias=1.0, n_r1=3, n_r2=5, m=2, nu=2)}


@pytest.fixture(scope="module")
def lenet_cal(lenet):
    """The reference's Fig. 6 calibration of LeNet: Algorithm 1 at
    n_max = 4 on its bit-line samples, and its forward on those registers
    with the two convs' set to ``TWIN`` (a mix of twin and uniform
    layers)."""
    cal = {n: jcalibrate(y, n_max=4) for n, y in lenet.samples.items()}
    regs = {n: c.params for n, c in cal.items()}
    regs.update({n: jmake(**r) for n, r in TWIN.items()})
    return lenet.samples, cal, regs, lenet.run_ref(regs)


def _case(request, name):
    return request.getfixturevalue({"lenet5": "lenet",
                                    "resnet20": "resnet"}[name])


def _t_params(p):
    """A reference TRQParams as the port's."""
    if p is None:
        return None
    return tmake(delta_r1=float(p.delta_r1), bias=float(p.bias),
                 n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode,
                 signed=p.signed)


# ---------------------------------------------------------------------------
# data, mapping, im2col
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,ch,split", [(28, 1, 0), (8, 3, 1)])
def test_vision_dataset_is_the_reference_bit_for_bit(hw, ch, split):
    x, y = vision_dataset(6, hw=hw, ch=ch, seed=5, noise=NOISE, split=split,
                          device="cpu")
    xj, yj = jvision(6, hw=hw, ch=ch, seed=5, noise=NOISE, split=split)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


def test_vision_dataset_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision_dataset(2)


@pytest.mark.parametrize("args", [("fc", 400, 120, 1), ("fc", 1000, 40, 3),
                                  ("conv", 3, 16, 3, 32, 32),
                                  ("conv", 64, 64, 3, 8, 8)])
def test_layer_mapping_counts_match_reference(args):
    if args[0] == "fc":
        got = tmap.map_linear("l", *args[1:])
        want = jmap.map_linear("l", *args[1:])
    else:
        got = tmap.map_conv2d("l", *args[1:])
        want = jmap.map_conv2d("l", *args[1:])
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.conversions_per_inference == want.conversions_per_inference


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (5, 1, 2),
                                          (5, 1, 0), (1, 2, 0)])
def test_im2col_pads_with_the_zero_point(k, stride, pad):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.integers(0, 256, (2, 9, 9, 3)).astype(np.int32)
    got = tmap.im2col(torch.from_numpy(x), k, stride, pad, pad_value=117)
    want = np.asarray(jmap.im2col(jnp.asarray(x), k, stride, pad,
                                  pad_value=117))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _conv_operands(seed, c_in=3, c_out=8, hw=9):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (2, hw, hw, c_in)).astype(np.int32)
    w = rng.integers(-128, 128, (3, 3, c_in, c_out)).astype(np.int32)
    return x, w


CONV_REGS = {"lossless": None,
             "twin": dict(delta_r1=1.0, bias=0.0, n_r1=4, n_r2=4, m=3),
             "twin-bias": dict(delta_r1=1.0, bias=1.0, n_r1=3, n_r2=5, m=2),
             "uniform": dict(delta_r1=2.5, bias=0.0, n_r1=6, n_r2=6, m=0,
                             mode="uniform")}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("regs", list(CONV_REGS))
def test_conv2d_pim_is_the_reference_bit_for_bit(regs, stride):
    from repro_torch.kernels.xbar_mvm import pack_weight_planes
    x, w = _conv_operands(stride)
    r = CONV_REGS[regs]
    jp = jmake(**r) if r else None
    tp = tmake(**r) if r else None
    out, ops = tmap.conv2d_pim(torch.from_numpy(x), torch.from_numpy(w), tp,
                               stride=stride, pad=1, pad_value=117,
                               with_ops=True)
    jout, jops = _JCONV(jnp.asarray(x), jnp.asarray(w), jp, stride=stride,
                        pad=1, pad_value=117, with_ops=True)
    jout = np.asarray(jout)
    assert np.abs(jout).max() < 2 ** 24            # the exactness precondition
    np.testing.assert_array_equal(out.numpy(), jout)
    assert ops.dtype == torch.int64 and int(ops) == float(jops)
    mask = pack_weight_planes(torch.from_numpy(w).reshape(-1, 8) + 128, 8)
    out_m, ops_m = tmap.conv2d_pim(torch.from_numpy(x), torch.from_numpy(w),
                                   tp, stride=stride, pad=1, pad_value=117,
                                   with_ops=True, w_mask=mask)
    assert torch.equal(out_m, out) and int(ops_m) == int(ops)


def test_conv2d_bl_samples_are_the_reference_bit_for_bit():
    x, w = _conv_operands(9)
    got = tmap.conv2d_bl_samples(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=2, pad=1, pad_value=31)
    want = np.asarray(_JCONV_BL(jnp.asarray(x), jnp.asarray(w), stride=2,
                                pad=1, pad_value=31))
    assert got.shape == want.shape == (8, 8, 1, 2 * 5 * 5, 8)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the CNNs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_init_cnn_has_the_reference_layout(name):
    spec_j, spec_t = MODELS[name]
    want = jax.eval_shape(lambda k: J.init_cnn(k, spec_j),
                          jax.random.PRNGKey(0))
    got = T.init_cnn(spec_t, seed=0, device="cpu")
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == ["b", "w"]
        for leaf in ("w", "b"):
            assert tuple(got[n][leaf].shape) == want[n][leaf].shape
            assert got[n][leaf].dtype == torch.float32
        fan_in = int(np.prod(want[n]["w"].shape[:-1]))
        assert not bool(got[n]["b"].any())
        std = float(got[n]["w"].std())
        assert 0.6 < std / np.sqrt(2.0 / fan_in) < 1.4, n
    again = T.init_cnn(spec_t, seed=0, device="cpu")
    assert all(torch.equal(again[n]["w"], got[n]["w"]) for n in got)


@pytest.mark.parametrize("name", list(MODELS))
def test_apply_cnn_matches_reference(request, name):
    c = _case(request, name)
    got = T.apply_cnn(c.pt, c.xt, c.spec_t)
    want = np.asarray(J.apply_cnn(c.pj, c.xj, c.spec_j))
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_cnn_matches_reference(request, name):
    c = _case(request, name)
    assert c.qt.pim_layers == c.qj.pim_layers
    for n in c.qj.pim_layers:
        np.testing.assert_array_equal(c.qt.w_int[n].numpy(),
                                      np.asarray(c.qj.w_int[n]))
        assert float(c.qt.w_scale[n]) == float(c.qj.w_scale[n])
        np.testing.assert_allclose(float(c.qt.a_scale[n]),
                                   float(c.qj.a_scale[n]), rtol=1e-6)
        assert int(c.qt.a_zero[n]) == int(c.qj.a_zero[n])
    assert any(int(z) > 0 for z in c.qt.a_zero.values())   # the input layer


def _grid_unit(p):
    """The power of two, at least 2^-8, that the register's steps and
    offset are whole multiples of (every quantized bit-line sum is then a
    multiple of it): 1 for lossless; None for a non-dyadic step."""
    if p is None:
        return 1.0
    for k in range(9):
        u = 2.0 ** -k
        if all(float(v / u).is_integer() for v in
               (np.float32(p.delta_r1), np.float32(p.offset))):
            return u
    return None


def _check_layers(c, layers, regs: dict):
    """Each port layer on the reference's quantized layer input, through
    the programmed masks as pim_forward runs it: ops equal, the output bit
    for bit on an exact grid, else within the two orders' rounding."""
    assert len(layers) == len(c.qt.pim_layers)
    spec = {f"{l[0]}{li}": l for li, l in enumerate(c.spec_t.layers)}
    for name, (xq, out_ref, ops_ref) in zip(c.qt.pim_layers, layers):
        unit = _grid_unit(regs.get(name))
        l = spec[name]
        trq = _t_params(regs.get(name))
        xq_t = torch.from_numpy(np.array(xq))
        if l[0] == "conv":
            out, ops = tmap.conv2d_pim(
                xq_t, c.qt.w_int[name], trq, stride=l[4],
                pad=T._pad_amount(l), pad_value=int(c.qt.a_zero[name]),
                with_ops=True, w_mask=c.qt.w_mask[name])
        else:
            out, ops = T.xbar_mvm_packed(xq_t, c.qt.w_mask[name], trq,
                                         per_output=False)
        assert int(ops) == ops_ref, name
        if unit is not None:
            # exactness precondition: every sum below 2^24 grid units
            assert np.abs(out_ref).max() < 2 ** 24 * unit, name
            np.testing.assert_array_equal(out.numpy(), out_ref, err_msg=name)
        else:
            rows = int(np.prod(c.qt.w_int[name].shape[:-1]))
            groups = -(-rows // 128)
            bar = 64 * groups * 2.0 ** -23 * np.abs(out_ref.astype(np.float64))
            err = np.abs(out.numpy().astype(np.float64) - out_ref)
            assert bool((err <= bar).all()), name


@pytest.mark.parametrize("name", list(MODELS))
def test_pim_forward_layers_are_the_reference_bit_for_bit(request, name):
    c = _case(request, name)
    _check_layers(c, c.lossless[2], {})


def test_pim_forward_layers_with_calibrated_registers(lenet, lenet_cal):
    _, _, regs, (_, _, layers) = lenet_cal
    assert {p.mode for p in regs.values()} == {"twin", "uniform"}
    _check_layers(lenet, layers, regs)


def _whole(c, trq, want):
    logits, ops = T.pim_forward(c.qt, c.xt[:N_IMG], trq, with_ops=True)
    w_logits, w_ops, _ = want
    np.testing.assert_allclose(logits.numpy(), w_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  w_logits.argmax(-1))
    assert ops.dtype == torch.int64 and int(ops) == w_ops
    return int(ops)


@pytest.mark.parametrize("name", list(MODELS))
def test_pim_forward_whole_network_matches_reference(request, name):
    c = _case(request, name)
    ops = _whole(c, None, c.lossless)
    # lossless: every conversion takes r_adc = 8 ops, on the real shapes
    assert ops == 8 * N_IMG * T.real_conversions(c.spec_t)


def test_pim_forward_with_calibrated_registers(lenet, lenet_cal):
    _, _, regs, want = lenet_cal
    ops = _whole(lenet, {n: _t_params(p) for n, p in regs.items()}, want)
    assert ops < 8 * N_IMG * T.real_conversions(lenet.spec_t)


@pytest.mark.parametrize("name", list(MODELS))
def test_uniform_conversions_match_reference(request, name):
    c = _case(request, name)
    for n in (1, 3):
        assert T.uniform_conversions(c.qt, n) == \
            J.uniform_conversions(c.qj, n)
    if name == "lenet5":
        # the reference counts the VALID conv3 at 14 x 14 positions, not 10 x 10
        assert T.uniform_conversions(c.qt, 1) == 739_200
        assert T.real_conversions(c.spec_t) == 542_592
        assert T.real_conversions(T.RESNET20) == 29_885_056


def test_collect_bl_samples_and_calibration_match_reference(lenet,
                                                            lenet_cal):
    """The port's ``collect_bl`` (the Fig. 6 benchmark's) gives the
    reference's samples bit for bit, in C order, and Algorithm 1 picks
    identical registers on every layer."""
    fig6 = importlib.import_module("benchmarks.fig6_accuracy_torch")
    samples, cal, _, _ = lenet_cal
    got = fig6.collect_bl(lenet.qt, lenet.xt[:N_IMG])
    assert list(got) == list(samples)
    for n, y in samples.items():
        np.testing.assert_array_equal(got[n].numpy(), y, err_msg=n)
        c = calibrate_layer(got[n], n_max=4)
        w = cal[n]
        p, q = c.params, w.params
        assert (c.chosen, p.mode, p.n_r1, p.n_r2, p.m, p.nu) == \
            (w.chosen, q.mode, q.n_r1, q.n_r2, q.m, q.nu), n
        assert float(p.delta_r1) == float(np.float32(q.delta_r1)), n
        assert float(p.bias) == float(np.float32(q.bias)), n
        assert c.mean_ops == pytest.approx(w.mean_ops, rel=1e-6), n


def test_train_step_matches_reference_loss_and_gradient(lenet):
    """One step of the benchmarks' ``_train_cnn`` loop: the port's loss and
    autograd gradient against ``jax.value_and_grad`` of the reference's
    loss, on the same batch and parameters, and the momentum update."""
    common = importlib.import_module("benchmarks.common_torch")
    spec_j, spec_t = MODELS["lenet5"]
    x, y = vision_dataset(16, seed=0, noise=NOISE, device="cpu")
    idx = np.random.default_rng(0).integers(0, 16, 8)

    def jloss(p, xb, yb):
        logits = J.apply_cnn(p, xb, spec_j)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, yb[:, None], -1)[:, 0]
        return jnp.mean(logz - gold)

    want_l, want_g = jax.value_and_grad(jloss)(
        lenet.pj, jnp.asarray(x.numpy()[idx]), jnp.asarray(y.numpy()[idx]))
    params = cnn_from_jax(lenet.p_np)
    leaves = [params[n][k].requires_grad_(True)
              for n in params for k in ("w", "b")]
    loss = common.cnn_loss(params, x[idx], y[idx], spec_t)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-4)
    for g, (n, k) in zip(grads, [(n, k) for n in params for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[n][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=f"{n}.{k}")
    # one step of the loop from the port's seeded init: p - lr * g
    trained, _ = common._train_cnn(spec_t, n_train=16, steps=1, batch=8,
                                   device="cpu")
    p0 = T.init_cnn(spec_t, seed=0, device="cpu")
    leaves0 = [p0[n][k].requires_grad_(True) for n in p0 for k in ("w", "b")]
    g0 = torch.autograd.grad(common.cnn_loss(p0, x[idx], y[idx], spec_t),
                             leaves0)
    for (n, k), g in zip([(n, k) for n in p0 for k in ("w", "b")], g0):
        torch.testing.assert_close(trained[n][k],
                                   p0[n][k].detach() - 3e-3 * g,
                                   rtol=0, atol=0)

"""CNNs for the paper's own evaluation (§V: LeNet-5, ResNet-20-class), port
of ``repro.models.cnn``, with two inference datapaths:

  float      plain f32 (training and the "f/f" reference row of Fig. 6)
  bit_exact  the full ISAAC sliced crossbar with a (TRQ-)ADC per
             conversion (the "8/f + ADC" rows of Fig. 6a/6b) and exact A/D
             op counts: every conv and FC layer runs the ``xbar_mvm``
             kernel (its plain version on a CPU tensor)

Weights/activations use 8-bit symmetric/unsigned PTQ with max-abs scaling
(paper §V-A).  Norm-free conv blocks (He init) keep the PIM fold-in
trivial.  Parameters are the reference's flat dict: ``conv{li}``,
``fc{li}`` and ``proj{li}``, each with ``w`` (HWIO, or (K, N) for FC) and
``b``, so ``convert.cnn_from_jax`` converts every leaf as it is.

Float order, as the reference: divisions by a constant divide by a device
tensor (a CUDA tensor divided by a host scalar is multiplied by its
reciprocal, which can move the last bit), and TF32 is switched off before
every float conv and product (the PTQ taps and the float accuracy are f32).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.xbar_mvm import pack_weight_planes, xbar_mvm_packed
from ..pim.crossbar import PimConfig, collect_bl_samples
from ..pim.mapping import conv2d_bl_samples, conv2d_pim, map_conv2d, \
    map_linear


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on x's device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# float path
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> tuple:
    """lax's "SAME" padding (lo, hi): the total puts ceil(size / stride)
    windows, the extra one goes high (stride 2 on 32 pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, p: dict, stride: int = 1,
           pad: str = "SAME") -> torch.Tensor:
    """NHWC x HWIO conv with lax's "SAME"/"VALID" padding, plus bias."""
    k = p["w"].shape[0]
    xc = x.permute(0, 3, 1, 2)
    if pad == "SAME":
        lo_h, hi_h = _same_pads(x.shape[1], k, stride)
        lo_w, hi_w = _same_pads(x.shape[2], k, stride)
        xc = F.pad(xc, (lo_w, hi_w, lo_h, hi_h))
    y = F.conv2d(xc, p["w"].permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def avgpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """VALID k x k average pool, stride k: the window sum over k*k."""
    b, h, w, c = x.shape
    x = x[:, :h // k * k, :w // k * k]
    s = x.reshape(b, h // k, k, w // k, k, c).sum(dim=(2, 4))
    return _div(s, float(k * k))


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    name: str
    layers: tuple            # sequence of ('conv', k, cin, cout, stride, pad)
                             # / ('pool', k) / ('fc', din, dout) / ('relu',)
                             # / ('gap',) global average pool
    input_hw: int
    in_ch: int
    n_classes: int


LENET5 = CNNSpec("lenet5", (
    ("conv", 5, 1, 6, 1, "SAME"), ("relu",), ("pool", 2),
    ("conv", 5, 6, 16, 1, "VALID"), ("relu",), ("pool", 2),
    ("flatten",),
    ("fc", 400, 120), ("relu",),
    ("fc", 120, 84), ("relu",),
    ("fc", 84, 10),
), 28, 1, 10)


def _resnet20_layers():
    ls = [("conv", 3, 3, 16, 1, "SAME"), ("relu",)]
    cin = 16
    for stage, ch in enumerate((16, 32, 64)):
        for blk in range(3):
            stride = 2 if (stage > 0 and blk == 0) else 1
            ls += [("res_begin",),
                   ("conv", 3, cin, ch, stride, "SAME"), ("relu",),
                   ("conv", 3, ch, ch, 1, "SAME"),
                   ("res_end", cin, ch, stride), ("relu",)]
            cin = ch
    ls += [("gap",), ("fc", 64, 10)]
    return tuple(ls)


RESNET20 = CNNSpec("resnet20", _resnet20_layers(), 32, 3, 10)


def init_cnn(spec: CNNSpec, seed: int = 0, device=None) -> dict:
    """He-normal weights and zero biases from the port's own seeded
    generator (the reference's distributions; ``jax.random`` streams
    cannot be replayed in torch), on ``device`` (the card by default)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(shape, fan_in):
        w = torch.randn(*shape, generator=gen, device=device)
        return {"w": w * float(np.sqrt(2.0 / fan_in)),
                "b": torch.zeros(shape[-1], device=device)}

    params = {}
    for li, l in enumerate(spec.layers):
        if l[0] == "conv":
            params[f"conv{li}"] = leaf((l[1], l[1], l[2], l[3]),
                                       l[1] * l[1] * l[2])
        elif l[0] == "fc":
            params[f"fc{li}"] = leaf((l[1], l[2]), l[1])
        elif l[0] == "res_end":
            cin, cout, stride = l[1], l[2], l[3]
            if cin != cout or stride != 1:
                params[f"proj{li}"] = leaf((1, 1, cin, cout), cin)
    return params


def apply_cnn(params: dict, x: torch.Tensor, spec: CNNSpec,
              tap: Optional[Callable[[str, torch.Tensor], None]] = None):
    """Float forward.  ``tap(name, pre_activation)`` observes layer inputs
    (PTQ calibration fixes the activation scales with it)."""
    _no_tf32()
    res_stack = []
    for li, l in enumerate(spec.layers):
        if l[0] == "conv":
            if tap:
                tap(f"conv{li}", x)
            x = conv2d(x, params[f"conv{li}"], l[4], l[5])
        elif l[0] == "fc":
            if tap:
                tap(f"fc{li}", x)
            x = x @ params[f"fc{li}"]["w"] + params[f"fc{li}"]["b"]
        elif l[0] == "relu":
            x = torch.relu(x)
        elif l[0] == "pool":
            x = avgpool(x, l[1])
        elif l[0] == "flatten":
            x = x.reshape(x.shape[0], -1)
        elif l[0] == "gap":
            x = x.mean(dim=(1, 2))
        elif l[0] == "res_begin":
            res_stack.append(x)
        elif l[0] == "res_end":
            skip = res_stack.pop()
            cin, cout, stride = l[1], l[2], l[3]
            if cin != cout or stride != 1:
                skip = conv2d(skip, params[f"proj{li}"], stride, "SAME")
            x = x + skip
    return x


# ---------------------------------------------------------------------------
# PTQ + PIM inference path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedCNN:
    spec: CNNSpec
    params: dict             # float params (for pool/residual paths)
    w_int: dict              # int8-valued weights per pim layer (int32)
    w_scale: dict            # per-layer weight scales (0-dim f32)
    a_scale: dict            # per-layer activation scales (uint8 grid)
    a_zero: dict             # per-layer activation zero-points (0-dim int32)
    pim_layers: tuple        # names in order
    w_mask: dict             # programmed cell masks (pack_weight_planes)


def quantize_cnn(params: dict, spec: CNNSpec,
                 calib_x: torch.Tensor) -> QuantizedCNN:
    """8-bit symmetric weights + asymmetric unsigned 8-bit activations
    (min/max scales from a calibration batch), per paper §V-A; each
    layer's weights are programmed once as ``xbar_mvm`` cell masks (8-bit
    cells, the default ``PimConfig``).

    The reference's own chain: ``ws = max(max|w|, 1e-8) / 127`` as a
    division, round half to even, ``a_zero = round(-lo / a_scale)``.  The
    DAC feeds unsigned codes; real-valued zero encodes as ``zp`` and the
    digital S+A subtracts the exact ``zp * colsum(W)``.  Post-ReLU layers
    get zp = 0."""
    lo, hi = {}, {}

    def tap(n, v):
        lo[n] = torch.clamp_max(torch.min(v), 0.0)
        hi[n] = torch.max(v)

    with torch.no_grad():
        apply_cnn(params, calib_x, spec, tap=tap)
    w_int, w_scale, a_scale, a_zero, w_mask, names = {}, {}, {}, {}, {}, []
    for li, l in enumerate(spec.layers):
        if l[0] not in ("conv", "fc"):
            continue
        name = f"{l[0]}{li}"
        names.append(name)
        w = params[name]["w"].detach()
        ws = _div(torch.clamp_min(torch.max(torch.abs(w)), 1e-8), 127.0)
        w_int[name] = torch.clamp(torch.round(w / ws), -128, 127).to(
            torch.int32)
        w_scale[name] = ws
        span = torch.clamp_min(hi[name] - lo[name], 1e-8)
        a_scale[name] = _div(span, 255.0)
        a_zero[name] = torch.round(-lo[name] / a_scale[name]).to(torch.int32)
        u = w_int[name].reshape(-1, w.shape[-1]) + 128     # 8-bit cells
        w_mask[name] = pack_weight_planes(u, 8)
    return QuantizedCNN(spec, params, w_int, w_scale, a_scale, a_zero,
                        tuple(names), w_mask)


def pim_forward(q: QuantizedCNN, x: torch.Tensor,
                trq_per_layer: Optional[dict] = None,
                cfg: PimConfig = PimConfig(), with_ops: bool = False,
                tap_bl: Optional[Callable[[str, torch.Tensor], None]] = None):
    """Bit-exact PIM inference, every conv and FC layer through the
    ``xbar_mvm`` kernel.  ``trq_per_layer[name]`` is a TRQParams (or None
    for the native full-precision R_ADC conversion).  Activations are
    re-quantized unsigned-8b before each PIM layer (SH+DAC behavior).
    ``tap_bl(name, samples)`` observes each layer's raw bit-line sums,
    (k_i, k_w, G, M, N) f32.  With ``with_ops`` the total A/D operations
    come back as an int64 tensor (the reference sums them in f32)."""
    _no_tf32()
    spec = q.spec
    res_stack = []
    total_ops = torch.zeros((), dtype=torch.int64, device=x.device)
    with torch.no_grad():
        for li, l in enumerate(spec.layers):
            if l[0] in ("conv", "fc"):
                name = f"{l[0]}{li}"
                trq = (trq_per_layer or {}).get(name)
                a_s = q.a_scale[name]
                zp = q.a_zero[name]
                xq = torch.clamp(torch.round(x / a_s) + zp, 0, 255).to(
                    torch.int32)
                if l[0] == "conv":
                    conv = dict(stride=l[4], pad=_pad_amount(l),
                                pad_value=int(zp), cfg=cfg)
                    if tap_bl is not None:
                        tap_bl(name, conv2d_bl_samples(xq, q.w_int[name],
                                                       **conv))
                    out, ops = conv2d_pim(xq, q.w_int[name], trq,
                                          with_ops=True,
                                          w_mask=q.w_mask[name], **conv)
                else:
                    if tap_bl is not None:
                        tap_bl(name, collect_bl_samples(xq, q.w_int[name],
                                                        cfg))
                    # the reference calls bit_exact_mvm directly
                    out, ops = xbar_mvm_packed(
                        xq, q.w_mask[name], trq, k_i=cfg.k_i, k_w=cfg.k_w,
                        r_adc=cfg.r_adc, per_output=False)
                total_ops = total_ops + ops
                # digital zero-point correction: (xq - zp) @ W = out - zp*colsum
                w_cols = torch.sum(q.w_int[name].float(),
                                   dim=tuple(range(q.w_int[name].ndim - 1)))
                out = out - zp.float() * w_cols
                x = out * (a_s * q.w_scale[name]) + q.params[name]["b"]
            elif l[0] == "relu":
                x = torch.relu(x)
            elif l[0] == "pool":
                x = avgpool(x, l[1])
            elif l[0] == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif l[0] == "gap":
                x = x.mean(dim=(1, 2))
            elif l[0] == "res_begin":
                res_stack.append(x)
            elif l[0] == "res_end":
                skip = res_stack.pop()
                cin, cout, stride = l[1], l[2], l[3]
                if cin != cout or stride != 1:
                    skip = conv2d(skip, q.params[f"proj{li}"], stride,
                                  "SAME")
                x = x + skip
    return (x, total_ops) if with_ops else x


def _pad_amount(l) -> int:
    # symmetric k // 2 for "SAME": the float path's lax padding is (0, 1) at
    # stride 2, so the PIM and float windows of a stride-2 conv sit one
    # pixel apart, as in the reference
    return (l[1] // 2) if l[5] == "SAME" else 0


def uniform_conversions(q: QuantizedCNN, n_images: int,
                        cfg: PimConfig = PimConfig()) -> int:
    """Total A/D conversions per ``n_images`` inferences (Eq. 4), for the
    energy baseline, as the reference counts them: ``out_hw = x_hw //
    stride`` (so a VALID conv counts the positions of a SAME one)."""
    total = 0
    x_hw = q.spec.input_hw
    for li, l in enumerate(q.spec.layers):
        if l[0] == "conv":
            out_hw = x_hw // l[4]
            m = map_conv2d(f"conv{li}", l[2], l[3], l[1], out_hw, out_hw, cfg)
            total += m.conversions_per_inference
            x_hw = out_hw
        elif l[0] == "pool":
            x_hw //= l[1]
        elif l[0] == "fc":
            m = map_linear(f"fc{li}", l[1], l[2], 1, cfg)
            total += m.conversions_per_inference
    return total * n_images


def pim_shapes(spec: CNNSpec, n_images: int = 1) -> list:
    """``(name, M, K, N)`` of every crossbar MVM ``pim_forward`` runs on
    ``n_images`` images: each conv's real output positions (VALID shrinks;
    stride and the symmetric PIM padding as the datapath pads) times the
    images, and one row an image for an FC layer."""
    shapes = []
    hw = spec.input_hw
    for li, l in enumerate(spec.layers):
        if l[0] == "conv":
            hw = (hw + 2 * _pad_amount(l) - l[1]) // l[4] + 1
            shapes.append((f"conv{li}", n_images * hw * hw,
                           l[1] * l[1] * l[2], l[3]))
        elif l[0] == "pool":
            hw //= l[1]
        elif l[0] == "fc":
            shapes.append((f"fc{li}", n_images, l[1], l[2]))
    return shapes


def real_conversions(spec: CNNSpec, cfg: PimConfig = PimConfig()) -> int:
    """A/D conversions of one image on the datapath ``pim_forward`` runs
    (Eq. 4 on :func:`pim_shapes`)."""
    return sum(map_linear(name, k, n, m, cfg).conversions_per_inference
               for name, m, k, n in pim_shapes(spec))

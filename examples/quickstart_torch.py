"""Quickstart on the PyTorch/CUDA port: the paper's technique in ~150 lines
(a port of ``examples/quickstart.py``).

1. Build a skewed bit-line distribution (what ReRAM crossbars emit).
2. Calibrate TRQ with Algorithm 1 (its candidates scored by the
   ``trq_quant`` kernel's scoring entry), no retraining.
3. Quantize + count A/D operations; compare against the 8-bit uniform SAR.
4. Run the same thing through the ``trq_quant`` kernel's elementwise entry
   and check it against the behavioral model bit for bit.
5. Run one MVM on every registered PIM execution backend (``pallas``
   reaches the ``trq_group_mvm`` kernel, ``bit_exact`` the ``xbar_mvm``
   kernel): the same ``PimOut(y, ad_ops)`` contract every layer consumes.
6. The front door: compile a ``repro_torch.runtime.Runtime`` over a small
   LM and read the A/D-energy report off every call.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core.calibrate import calibrate_layer
from repro_torch.core.energy import R_ADC_DEFAULT, adc_energy_pj
from repro_torch.core.trq import make_params, trq_ad_ops, trq_quant
from repro_torch.kernels.trq_quant import trq_quant as trq_quant_kernel
from repro_torch.models.registry import get_config, init
from repro_torch.pim import list_backends, pim_mvm


def skewed_samples(rng) -> np.ndarray:
    """Step 1: a Fig-3a-style BL distribution, dense near zero plus a
    sparse tail, on integers (bit-line sums are integers)."""
    y = np.abs(rng.normal(0, 2.5, 100_000))
    tail = rng.random(100_000) < 0.04
    y[tail] += rng.uniform(20, 120, tail.sum())
    y = np.round(y)
    print(f"samples: median={np.median(y):.0f}  "
          f"p99={np.percentile(y, 99):.0f}  max={y.max():.0f}")
    return y


def calibrate(y: np.ndarray, device):
    """Step 2: Algorithm-1 calibration on the samples, on ``device``."""
    cal = calibrate_layer(torch.tensor(y, dtype=torch.float32,
                                       device=device),
                          n_max=R_ADC_DEFAULT - 1)
    p = cal.params
    print(f"calibrated: chosen={cal.chosen}  n_r1={p.n_r1}  n_r2={p.n_r2}  "
          f"m={p.m}  delta_r1={float(p.delta_r1):.3f}  "
          f"bias={float(p.bias):.0f}")
    return cal


def quantize(y: np.ndarray, p, device):
    """Step 3: quantize 4,096 samples and count their A/D operations."""
    yt = torch.tensor(y[:4096], dtype=torch.float32, device=device)
    p = p.to(device)
    q = trq_quant(yt, p)
    ops = trq_ad_ops(yt, p)
    mse = float(torch.mean((q - yt) ** 2))
    mean_ops = float(ops.float().mean())
    print(f"TRQ:     mse={mse:.4f}  ops/conversion={mean_ops:.2f}")
    print(f"uniform: ops/conversion={R_ADC_DEFAULT}.00 (always full search)")
    ratio = mean_ops / R_ADC_DEFAULT
    print(f"ADC dynamic energy: {ratio:.1%} of baseline "
          f"({1 / ratio:.2f}x improvement; paper reports 1.6-2.3x)")
    e_trq = adc_energy_pj(int(ops.sum()))
    e_uni = adc_energy_pj(R_ADC_DEFAULT * ops.numel())
    print(f"energy for {ops.numel()} conversions: {e_trq:.0f} pJ vs "
          f"{e_uni:.0f} pJ")
    return yt, q, ops


def kernel_check(yt: torch.Tensor, q: torch.Tensor, ops: torch.Tensor, p):
    """Step 4: the same math through the ``trq_quant`` kernel's elementwise
    entry (its plain version on a CPU tensor), bit for bit."""
    q_k, ops_k = trq_quant_kernel(yt.reshape(64, 64), p.to(yt.device))
    if not (torch.equal(q_k.reshape(-1), q) and
            torch.equal(ops_k.reshape(-1), ops)):
        raise AssertionError("kernel != core")
    where = "CUDA kernel" if yt.is_cuda else "plain version"
    print(f"trq_quant {where} matches the behavioral model bit-for-bit")
    return q_k, ops_k


def backend_sweep(p, rng, device) -> dict:
    """Step 5: one MVM on every registered backend (per-group TRQ where it
    applies).  ``bit_exact`` registers act on the raw bit-line integer grid
    (calibrate on ``collect_bl_samples`` output), so it runs lossless."""
    x = torch.tensor(rng.normal(0, 1, (8, 256)), dtype=torch.float32,
                     device=device)
    w = torch.tensor(rng.normal(0, 1, (256, 16)), dtype=torch.float32,
                     device=device)
    pg = make_params(delta_r1=1.0, n_r1=p.n_r1, n_r2=p.n_r2, m=p.m,
                     signed=True, device=device)
    ref = pim_mvm(x, w, None, backend="exact").y
    print("backend sweep (same MVM, per-group TRQ where applicable):")
    out = {}
    for name in list_backends():
        res = pim_mvm(x, w, None if name == "bit_exact" else pg,
                      backend=name, auto_range=True)
        err = float(torch.linalg.norm(res.y - ref) / torch.linalg.norm(ref))
        out[name] = dict(rel_err=err, ad_ops=int(res.ad_ops))
        print(f"  {name:10s} rel_err={err:.4f}  "
              f"ad_ops={float(res.ad_ops):>9.0f}")
    return out


def front_door(rng, device) -> None:
    """Step 6: one compiled Runtime over the llama3.2-3b smoke config; every
    entry point returns (out, AdOpsReport)."""
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="fake_quant", remat="none")
    rt = runtime.compile(cfg, init(cfg, seed=0, device=device),
                         device=device)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 16))}
    _, report = rt.apply(batch)
    print(f"runtime: {rt}")
    print(f"one forward: {report.total():.0f} A/D ops "
          f"({report.ad_energy_pj:.0f} pJ, Eq. 6)")
    y, lrep = rt.mvm(torch.tensor(rng.normal(0, 1, (4, cfg.d_model)),
                                  dtype=torch.float32),
                     layer="layer_0/attn/wq")
    print(f"one layer ({tuple(y.shape)}): {lrep.total():.0f} A/D ops")
    _, exact_rep = rt.with_overrides(backend="exact").apply(batch)
    print(f"A/B via rt.with_overrides(backend='exact'): "
          f"{exact_rep.total():.0f} A/D ops (digital reference)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)
    rng = np.random.default_rng(0)
    y = skewed_samples(rng)
    p = calibrate(y, device).params
    yt, q, ops = quantize(y, p, device)
    kernel_check(yt, q, ops, p)
    backend_sweep(p, rng, device)
    front_door(rng, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

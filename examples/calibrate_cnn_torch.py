"""Paper pipeline end to end on the PyTorch/CUDA port (a port of
``examples/calibrate_cnn.py``): train LeNet-5, PTQ-quantize, map to the
ISAAC crossbar datapath (every conv and FC through the ``xbar_mvm``
kernel), calibrate TRQ (Algorithm 1, scored by the ``trq_quant`` kernel),
validate accuracy + energy, and hand the registers to an LM Runtime.

  float model --(8b PTQ)--> crossbar-mapped model --(Alg.1)--> TRQ config
        |                        |                                 |
     fp32 acc              8b-ADC acc                    4b-TRQ acc + op ratio

  PYTHONPATH=src python examples/calibrate_cnn_torch.py [--bits 4] \
      [--model resnet20] [--quick] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

# run from anywhere: the benchmarks package lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common_torch import accuracy, trained_cnn  # noqa: E402
from benchmarks.fig6_accuracy_torch import collect_bl, \
    uniform_params  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.core.calibrate import calibrate_layer, \
    summarize  # noqa: E402
from repro_torch.core.quant_state import (QuantState, load_quant_state,
                                          save_quant_state)  # noqa: E402
from repro_torch.models.cnn import apply_cnn, pim_forward  # noqa: E402
from repro_torch.models.registry import get_config, init  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--model", default="lenet5",
                    choices=["lenet5", "resnet20"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)

    spec, params, q, (x_test, y_test) = trained_cnn(args.model,
                                                    device=device)
    n = 128 if args.quick else 512
    x_ev, y_ev = x_test[:n], y_test[:n]

    with torch.no_grad():
        acc_f = accuracy(lambda xb: apply_cnn(params, xb, spec), x_ev, y_ev)
    print(f"[1/4] float32 accuracy:              {acc_f:.4f}")

    acc_8b = accuracy(lambda xb: pim_forward(q, xb, None), x_ev, y_ev)
    print(f"[2/4] crossbar + lossless 8b ADC:    {acc_8b:.4f}")

    print(f"[3/4] Algorithm-1 calibration at n_max={args.bits} "
          "(32 images, no retraining)...")
    bl = collect_bl(q, x_test[-32:])
    cal = {name: calibrate_layer(y, n_max=args.bits)
           for name, y in bl.items()}
    for name, c in cal.items():
        p = c.params
        print(f"      {name:8s} {c.chosen:7s} dist={c.dist.kind:6s} "
              f"n_r1={p.n_r1} n_r2={p.n_r2} m={p.m} "
              f"ops/conv={c.mean_ops:.2f} (uniform: {c.uniform_ops:.0f})")

    trq = {name: c.params for name, c in cal.items()}
    acc_trq = accuracy(lambda xb: pim_forward(q, xb, trq), x_ev, y_ev)
    uni = {name: uniform_params(y, args.bits) for name, y in bl.items()}
    acc_uni = accuracy(lambda xb: pim_forward(q, xb, uni), x_ev, y_ev)

    _, ops_trq = pim_forward(q, x_ev[:32], trq, with_ops=True)
    _, ops_full = pim_forward(q, x_ev[:32], None, with_ops=True)
    ratio = int(ops_trq) / int(ops_full)
    s = summarize(cal)

    print(f"[4/4] results at {args.bits}-bit budget:")
    print(f"      TRQ accuracy:     {acc_trq:.4f}  (drop vs 8b ADC: "
          f"{acc_8b - acc_trq:+.4f})")
    print(f"      uniform accuracy: {acc_uni:.4f}")
    print(f"      A/D ops remaining: {ratio:.1%}  "
          f"-> {1 / max(ratio, 1e-9):.2f}x ADC energy improvement "
          f"(paper: 1.6-2.3x)")
    print(f"      twin-range layers: {s['twin_layers']}/{s['layers']}")

    # [5/5] hand the registers to the serving stack: the calibrated state
    # persists as a versioned quant_state.json and drives an LM Runtime —
    # the same front door launch.serve / ServeEngine use.
    best = min(cal.values(), key=lambda c: c.mean_ops).params
    qs = QuantState(default=best.replace(signed=True))
    with tempfile.TemporaryDirectory() as d:
        qs = load_quant_state(save_quant_state(d, qs))   # schema-versioned
    lm_cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="fake_quant", remat="none")
    rt = runtime.compile(lm_cfg, init(lm_cfg, seed=0, device=device),
                         device=device, quant_state=qs)
    toks = {"tokens": np.random.default_rng(0).integers(
        0, lm_cfg.vocab_size, (1, 16))}
    _, rep = rt.apply(toks)
    _, rep_dflt = rt.with_overrides(quant_state=None).apply(toks)
    print(f"[5/5] registers deployed through repro_torch.runtime: "
          f"{rep.total():.0f} A/D ops per LM forward "
          f"(default registers: {rep_dflt.total():.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

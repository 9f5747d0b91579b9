"""Fig. 6a/6b — prediction accuracy vs ADC bit-width, Uniform vs TRQ, on
the port (a port of ``benchmarks/fig6_accuracy.py``).

The paper's claim: TRQ at 4-bit effective resolution reaches the accuracy
a uniform ADC needs ~7 bits for.  Run on the paper's own workload class
(LeNet-5; ResNet-20 with ``--model resnet20``) over the bit-exact ISAAC
datapath (every conv and FC through the ``xbar_mvm`` kernel), with
Algorithm-1 calibration (each layer scored by ``trq_quant``'s scoring
entry) and NO retraining.

  PYTHONPATH=src python -m benchmarks.fig6_accuracy_torch [--quick] \
      [--model resnet20] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import torch

from repro_torch.core.calibrate import calibrate_layer
from repro_torch.core.trq import make_params
from repro_torch.models.cnn import apply_cnn, pim_forward

from .common_torch import accuracy, emit, trained_cnn


def collect_bl(q, x) -> dict:
    """Each PIM layer's raw bit-line sums on ``x``, flattened in C order
    (the reference's ``np.asarray(s).ravel()``), on x's device."""
    samples: dict = {}
    pim_forward(q, x, tap_bl=lambda n, s: samples.setdefault(n, []).append(
        s.reshape(-1)))
    return {k: torch.cat(v) for k, v in samples.items()}


def uniform_params(y: torch.Tensor, bits: int):
    """Best-effort plain uniform ADC at ``bits``: full-range max-abs scale
    (the paper's non-calibrated U baseline)."""
    delta = max(float(y.max()), 1.0) / (2 ** bits - 1)
    return make_params(delta_r1=delta, bias=0.0, n_r1=bits, n_r2=bits, m=0,
                       mode="uniform")


def run(quick: bool = False, model: str = "lenet5", device=None) -> dict:
    spec, params, q, (x_test, y_test) = trained_cnn(model, device=device)
    n_eval = 128 if quick else 512
    n_cal = 32                                     # paper: 32 calib images
    x_ev, y_ev = x_test[:n_eval], y_test[:n_eval]

    bl = collect_bl(q, x_test[-n_cal:])
    with torch.no_grad():
        results = {"float_acc": accuracy(
            lambda v: apply_cnn(params, v, spec), x_ev, y_ev)}
    emit(f"fig6.{model}.float", 0.0, f"acc={results['float_acc']:.4f}")

    # lossless-ADC PIM reference (the "8/f" row)
    acc_ref = accuracy(lambda xb: pim_forward(q, xb, None), x_ev, y_ev)
    results["pim_lossless_acc"] = acc_ref
    emit(f"fig6.{model}.pim8b", 0.0, f"acc={acc_ref:.4f}")

    bit_range = (8, 7, 6, 5, 4, 3, 2) if not quick else (8, 6, 4, 3)
    results["uniform"], results["trq"], results["trq_ops"] = {}, {}, {}
    for nb in bit_range:
        u = {name: uniform_params(y, nb) for name, y in bl.items()}
        acc_u = accuracy(lambda xb: pim_forward(q, xb, u), x_ev, y_ev)
        cal = {name: calibrate_layer(y, n_max=nb) for name, y in bl.items()}
        t = {name: c.params for name, c in cal.items()}
        acc_t = accuracy(lambda xb: pim_forward(q, xb, t), x_ev, y_ev)
        mean_ops = sum(c.mean_ops for c in cal.values()) / len(cal)
        results["uniform"][nb] = acc_u
        results["trq"][nb] = acc_t
        results["trq_ops"][nb] = mean_ops
        emit(f"fig6.{model}.{nb}bit", 0.0,
             f"acc_uniform={acc_u:.4f};acc_trq={acc_t:.4f};"
             f"trq_ops/conv={mean_ops:.2f}")

    # headline check: TRQ@4b within 1% of U@7b (paper's comparison)
    if 4 in results["trq"] and 7 in results["uniform"]:
        gap = results["uniform"][7] - results["trq"][4]
        emit(f"fig6.{model}.headline", 0.0,
             f"U@7b-TRQ@4b acc gap={gap:+.4f} (paper: ~0)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--model", default="lenet5",
                    choices=["lenet5", "resnet20"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.quick, model=args.model, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

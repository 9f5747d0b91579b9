"""Fig. 6c — remaining A/D operations under TRQ (exact op counts from the
bit-exact datapath), and Fig. 7 — system power breakdown, on the port (a
port of ``benchmarks/fig6c_fig7_energy.py``).

The paper's headline: ADC dynamic energy compressed to 42–62% (1.6–2.3x)
across workloads, at the 4-bit upper bound used for Fig. 7.  The op
totals are int64 (the reference sums them in f32).

  PYTHONPATH=src python -m benchmarks.fig6c_fig7_energy_torch [--quick] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.calibrate import calibrate_layer
from repro_torch.core.energy import system_power_breakdown
from repro_torch.models.cnn import pim_forward

from .common_torch import emit, trained_cnn
from .fig6_accuracy_torch import collect_bl


def run(quick: bool = False, models=("lenet5", "resnet20"),
        n_max: int = 4, device=None) -> dict:
    out = {}
    if quick:
        models = ("lenet5",)
    for model in models:
        spec, params, q, (x_test, _) = trained_cnn(model, device=device)
        bl = collect_bl(q, x_test[-32:])
        cal = {name: calibrate_layer(y, n_max=n_max)
               for name, y in bl.items()}
        trq = {name: c.params for name, c in cal.items()}

        # exact op counting on the bit-exact datapath (not the calib estimate)
        n_img = 16 if quick else 64
        _, ops_trq = pim_forward(q, x_test[:n_img], trq, with_ops=True)
        _, ops_full = pim_forward(q, x_test[:n_img], None, with_ops=True)
        ratio = int(ops_trq) / int(ops_full)
        out[model] = {"op_ratio": ratio, "n_img": n_img,
                      "ops_trq": int(ops_trq), "ops_full": int(ops_full),
                      "per_layer": {n: c.mean_ops for n, c in cal.items()}}
        emit(f"fig6c.{model}", 0.0,
             f"remaining_ops={ratio:.3f} (paper: 0.42-0.62);"
             f"improvement={1.0 / max(ratio, 1e-9):.2f}x")

        # Fig. 7: scale the ISAAC ADC power share by the measured ratio
        brk = system_power_breakdown(ratio)
        out[model]["power"] = brk
        emit(f"fig7.{model}", 0.0,
             ";".join(f"{k}={v:.3f}" for k, v in brk.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.quick, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

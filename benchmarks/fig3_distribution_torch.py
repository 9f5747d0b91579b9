"""Fig. 3a — value distribution at crossbar bit-lines, on the port (a port
of ``benchmarks/fig3_distribution.py``).

Collects real bit-line partial sums from the trained, PTQ-quantized
LeNet-5 on the ISAAC datapath (every layer through the ``xbar_mvm``
kernel) and reports skew statistics and the Algorithm-1 distribution
classification per layer.

  PYTHONPATH=src python -m benchmarks.fig3_distribution_torch [--quick] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core.distribution import classify

from .common_torch import emit, trained_cnn
from .fig6_accuracy_torch import collect_bl


def run(quick: bool = False, device=None) -> dict:
    spec, params, q, (x_test, _) = trained_cnn("lenet5", device=device)
    n = 32 if quick else 128
    out = {}
    for name, y in collect_bl(q, x_test[:n]).items():
        y = y.cpu().numpy()
        d = classify(y)
        med, p99, mx = np.median(y), np.percentile(y, 99), y.max()
        frac_small = float((y <= max(0.05 * mx, 1)).mean())
        out[name] = dict(kind=d.kind, median=float(med), p99=float(p99),
                         max=float(mx), frac_in_5pct_window=frac_small,
                         r_ideal=d.r_ideal)
        emit(f"fig3.{name}", 0.0,
             f"kind={d.kind};median={med:.1f};p99={p99:.1f};max={mx:.0f};"
             f"mass5%={frac_small:.2f}")
    skewed = sum(v["kind"] in ("ideal", "normal") for v in out.values())
    emit("fig3.summary", 0.0,
         f"{skewed}/{len(out)} layers skewed (paper: majority near zero)")
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

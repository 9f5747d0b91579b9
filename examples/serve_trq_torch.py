"""Serving with the paper's datapath on the PyTorch/CUDA port: a
continuous-batching engine over an LM whose every linear layer runs TRQ
partial-sum quantization on a selectable PIM backend (a port of
``examples/serve_trq.py``).

The flow: take the per-layer A/D census of one forward (its keys are the
layer names) -> Algorithm-1 calibration of each layer's SAR registers ->
``QuantState`` -> ``Runtime.save`` and reload next to a checkpoint ->
``repro_torch.runtime.compile`` -> serve, then the exact A/D-operation
count of one forward against a uniform 8-bit register file.

  PYTHONPATH=src python examples/serve_trq_torch.py            # the card:
      # full-width llama3.2-3b, seeded weights, --pim pallas (K1), the
      # calibration scored by K2
  PYTHONPATH=src python examples/serve_trq_torch.py --smoke --device cpu
"""
import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs.base import TRQConfig
from repro_torch.core.calibrate import calibrate_layer, to_quant_state
from repro_torch.core.energy import R_ADC_DEFAULT, adc_energy_pj
from repro_torch.core.quant_state import QuantState, load_quant_state
from repro_torch.core.trq import make_params
from repro_torch.models.registry import get_config, init
from repro_torch.pim import ad_ops_tally
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--pim", default="pallas",
                    choices=["fake_quant", "pallas"])
    ap.add_argument("--n-max", type=int, default=5,
                    help="Algorithm-1 register bit-width cap")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, d=96)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = runtime.resolve_device(args.device)
    trq = TRQConfig(n_r1=4, n_r2=4, m=3, signed=True)
    cfg = get_config("llama3.2-3b", smoke=args.smoke).replace(
        pim_backend=args.pim, trq=trq, remat="none")
    if not args.smoke:
        cfg = cfg.replace(param_dtype="bfloat16")
    print(f"serving {cfg.name}{'-smoke' if args.smoke else ''} on "
          f"backend={cfg.pim_backend}, device={device}")
    rng = np.random.default_rng(0)
    state = init(cfg, seed=0, device=device)

    # -- 1. Algorithm-1 calibration of per-layer SAR registers --------------
    # the A/D census of one unrolled forward names every linear layer (the
    # Runtimes below share the parameter tensors)
    cfg_u = cfg.replace(scan_layers=False)
    rt_u = runtime.compile(cfg_u, state, device=device, plan=None)
    toks = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    with ad_ops_tally() as census:
        rt_u.apply(toks, mode="train")
    layer_names = sorted(census.by_layer)
    # calibrate on a synthetic near-zero-concentrated sample per layer (a
    # real deployment feeds collect_bl_samples of each layer here)
    cal = {}
    for i, name in enumerate(layer_names):
        y = np.abs(rng.normal(0, 2.0 + i, 8192)).round()
        cal[name] = calibrate_layer(
            torch.tensor(y, dtype=torch.float32, device=device),
            n_max=args.n_max)
    qs = to_quant_state(cal, signed=True)
    print(f"calibrated {len(qs)} layers; mean ops/conv "
          f"{np.mean([c.mean_ops for c in cal.values()]):.2f} vs "
          f"{R_ADC_DEFAULT} uniform")

    # -- 2. registers persist next to the weights ---------------------------
    rt_u = rt_u.with_overrides(quant_state=qs)
    with tempfile.TemporaryDirectory() as d:
        qs = load_quant_state(rt_u.save(d))

    # -- 3. compile the Runtime and serve on it -----------------------------
    rt = runtime.compile(cfg, state, device=device, quant_state=qs)
    eng = ServeEngine(rt, max_batch=args.max_batch, max_len=128)
    for i in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, 8 + 4 * (i % 3)),
                   max_new_tokens=args.max_new)
    done = eng.run()
    st = eng.stats()
    print(f"served {st['requests']} requests | {st['decode_tokens']} "
          f"tokens | {st['tokens_per_s']:.1f} tok/s | ttft "
          f"{st['mean_ttft_s'] * 1e3:.0f} ms")

    # -- 4. exact energy accounting from the Runtime ------------------------
    # the unrolled model with per-depth registers, served dynamically; a
    # uniform R_ADC-bit register file spends exactly R_ADC ops per
    # conversion, so it is the baseline
    _, rep = rt_u.with_overrides(quant_state=qs).apply(toks, mode="train")
    uni_qs = QuantState(default=make_params(
        delta_r1=1.0, n_r1=R_ADC_DEFAULT, n_r2=R_ADC_DEFAULT, m=0,
        mode="uniform", signed=True))
    _, rep_uni = rt_u.with_overrides(quant_state=uni_qs).apply(
        toks, mode="train")
    total, total_uni = rep.total(), rep_uni.total()
    print(f"A/D ops for one forward: {total:.0f} "
          f"({adc_energy_pj(total):.0f} pJ) vs uniform "
          f"{R_ADC_DEFAULT}b {total_uni:.0f} "
          f"({adc_energy_pj(total_uni):.0f} pJ) -> "
          f"{total_uni / max(total, 1e-9):.2f}x fewer SAR cycles")
    for r in done[:4]:
        print(f"  req {r.uid} ({len(r.prompt)} prompt): {r.generated}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

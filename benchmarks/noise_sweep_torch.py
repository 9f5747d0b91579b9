"""Monte-Carlo accuracy-under-noise sweep of the PyTorch/CUDA port (a port of
``benchmarks/noise_sweep.py``).

For a tiny llama3.2-3b (2 layers, d=64, vocab 64) on the ``noisy`` backend
it sweeps the two failure families — per-read bit-line noise
(``read_sigma``, call-side, over per-call keys) and stuck-at-0 cell faults
(``sa0``, device-side, over fault seeds) — and records the divergence of
the last-token logits from the ideal ``bit_exact`` datapath:

* ``zero_noise_identity``  1.0 iff the all-zeros ``CrossbarModel`` is
  bitwise ``bit_exact`` (logits and ad_ops); ``traced_zero_identity`` the
  same for zero fields given as tensors, which take the full analog
  datapath.  ``check_regression`` gates both exactly.
* ``mean_div`` / ``worst_div``  mean / worst relative L2 divergence over
  the draws; ``top1_agree`` the fraction of unchanged argmax decisions;
  ``ad_ops_ratio`` noisy over ideal conversion cycles.

The draws are a ``torch.Generator`` stream, not the reference's threefry
one, so divergences compare with ``BENCH_kernels.json`` statistically, not
number for number; the identities compare exactly.  The reference vmaps
over the draws; here they run one after another (``us`` is the time of a
sweep point's ``N_MC`` forwards).

  PYTHONPATH=src python -m benchmarks.noise_sweep_torch [--quick] \
      [--device cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N_MC = 4                                     # Monte-Carlo draws per point
ARCH = "llama3.2-3b"


def tiny_config():
    from repro_torch.models.registry import get_config
    return get_config(ARCH, smoke=True).replace(
        remat="none", pim_backend="noisy", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=96, vocab_size=64)


def _slug(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _mc_stats(noisy, ref):
    """(N_MC, B, V) noisy last-token logits vs (B, V) reference."""
    ref = np.asarray(ref, np.float64)
    noisy = np.asarray(noisy, np.float64)
    div = (np.linalg.norm((noisy - ref).reshape(noisy.shape[0], -1), axis=1)
           / max(np.linalg.norm(ref), 1e-12))
    agree = np.mean(np.argmax(noisy, -1) == np.argmax(ref, -1))
    return float(div.mean()), float(div.max()), float(agree)


def run(quick: bool = False, device="cuda", state=None) -> dict:
    """Prints CSV lines, returns JSON-ready records keyed
    ``noise.<arch>.<point>``.  ``state``: the model's weights (default:
    the port's seeded init)."""
    import torch
    from repro_torch import runtime
    from repro_torch.models.registry import init
    from repro_torch.pim import CrossbarModel

    records: dict = {}

    def rec(name, us, derived="", **extra):
        print(f"{name},{us:.1f},{derived}")
        records[name] = {"us": float(us), "derived": derived, **extra}

    sigmas = (0.1, 0.3) if quick else (0.05, 0.1, 0.2, 0.4)
    safs = (0.01, 0.05) if quick else (0.005, 0.01, 0.02, 0.05)
    cfg = tiny_config()
    device = runtime.resolve_device(device)
    if state is None:
        state = init(cfg, seed=0, device=device)
    # the dynamic path (no plan): every call draws its device anew
    rt = runtime.compile(cfg, state, device=device, plan=None)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    slug = _slug(cfg.name)

    def fwd(model):
        (logits, _), r = rt.with_overrides(crossbar_model=model).prefill(
            toks, max_len=8)
        return logits.float().cpu().numpy(), r.total()

    def timed(models):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fwd(m) for m in models]
        return outs, (time.perf_counter() - t0) * 1e6

    # -- zero-noise identity: the gated bitwise claims ----------------------
    ref, ref_ops = fwd(None)
    z, z_ops = fwd(CrossbarModel())
    ident = float(np.array_equal(ref, z) and ref_ops == z_ops)
    zero = torch.zeros((), device=device)
    tz, tz_ops = fwd(CrossbarModel(
        g_sigma=zero, sa0=zero, sa1=zero, read_sigma=zero, ir_drop=zero,
        adc_offset=zero, adc_sigma=zero))
    t_ident = float(np.array_equal(ref, tz) and ref_ops == tz_ops)
    rec(f"noise.{slug}.zero_noise", 0.0,
        "all-zeros CrossbarModel vs bit_exact, logits+ad_ops bitwise",
        zero_noise_identity=ident, traced_zero_identity=t_ident)

    # -- accuracy vs read noise: N_MC per-call keys ---------------------------
    for sig in sigmas:
        outs, us = timed([CrossbarModel(read_sigma=sig, key=k)
                          for k in range(N_MC)])
        mean_d, worst_d, agree = _mc_stats([o[0] for o in outs], ref)
        tag = f"{sig:.2f}".replace(".", "p")
        rec(f"noise.{slug}.read_sigma_{tag}", us,
            f"sigma={sig}.n_mc={N_MC}", mean_div=mean_d, worst_div=worst_d,
            top1_agree=agree,
            ad_ops_ratio=float(np.mean([o[1] for o in outs]) / ref_ops))

    # -- accuracy vs stuck-at faults: N_MC device seeds -----------------------
    for rate in safs:
        outs, us = timed([CrossbarModel(sa0=rate, seed=sd)
                          for sd in range(N_MC)])
        mean_d, worst_d, agree = _mc_stats([o[0] for o in outs], ref)
        tag = f"{rate:.3f}".replace(".", "p")
        rec(f"noise.{slug}.saf_{tag}", us, f"sa0={rate}.n_mc={N_MC}",
            mean_div=mean_d, worst_div=worst_d, top1_agree=agree,
            ad_ops_ratio=float(np.mean([o[1] for o in outs]) / ref_ops))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    records = run(args.quick, args.device)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"bench": "noise", "quick": args.quick,
                       "device": args.device, "records": records}, f,
                      indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How often K1 (``trq_group_mvm``) and its plain version land a 128-row
group's partial sum on different sides of a quantizer step, and which of
the two sides an f64 control (the partial sums accumulated in f64 and
rounded once to f32) agrees with.

The inputs are ``chip_smoke.py`` phase 2's float cases (bf16-valued
operands, the default registers, given or auto-ranged), drawn afresh for
each of ``--seeds`` seeds at each shape.  An output "flips" where two
results differ by more than rtol = atol = 1e-5.  Needs a card:

  PYTHONPATH=src python tools/k1_flip_census.py --seeds 32 \\
      --out chiprun_out/k1_flips.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

SHAPES = [(1, 14336, 4096), (2, 14336, 4096), (4, 14336, 4096),
          (64, 14336, 4096), (1, 4096, 4096), (1, 8192, 3072),
          (1, 4096, 65536)]
TOL = 1e-5
XBAR = 128


def control(torch, a, w, scalars, *, n_r1, n_r2, m, nu, mode, auto_range):
    """The plain version with f64 partial sums rounded once to f32."""
    from repro_torch.core.trq import (TRQParams, auto_range_delta,
                                      trq_quant)
    mm, k = a.shape
    g = k // XBAR
    a_g = a.double().reshape(mm, g, XBAR)
    w_g = w.double().reshape(g, XBAR, -1)
    psum = torch.einsum("mgx,gxn->mgn", a_g, w_g).float()
    grid, delta_r1 = scalars[2], scalars[0]
    if auto_range:
        delta_r1 = auto_range_delta(delta_r1, torch.amax(torch.abs(psum)),
                                    grid, n_r2 + m)
    p = TRQParams(delta_r1=delta_r1, bias=scalars[1], n_r1=n_r1,
                  n_r2=n_r2, m=m, nu=nu, mode=mode, signed=True)
    q = trq_quant(psum / grid, p) * grid
    y = torch.zeros(q[:, 0].shape, dtype=torch.float32, device=a.device)
    for gi in range(g):
        y = y + q[:, gi]
    return y


def flips(x, y) -> int:
    return int(((x - y).abs() > TOL + TOL * y.abs()).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_flip_census: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.trq_group_mvm import pack_scalars
    from repro_torch.kernels.trq_group_mvm.kernel import trq_group_mvm_cuda
    from repro_torch.kernels.trq_group_mvm.ref import trq_group_mvm_ref
    from repro_torch.pim.backend import _dynamic_scales, grid_scale
    from repro_torch.pim.crossbar import auto_range_fit

    dev = torch.device("cuda")
    out = []
    for (mm, k, n) in SHAPES:
        for auto in (False, True):
            kr, kc, rc = [], [], []
            for seed in range(args.seeds):
                gen = torch.Generator(device=dev).manual_seed(seed)
                a = torch.randn(mm, k, generator=gen,
                                device=dev).bfloat16().float()
                w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
                     ).to(torch.bfloat16)
                a_s, w_s = _dynamic_scales(a, w.float(), None, None)
                grid = grid_scale(a_s, w_s, 1.0, dev)
                p = make_params(signed=True, device=dev, n_r1=6, n_r2=6, m=4)
                fitted = auto_range_fit(a, w.float(), p, grid)
                s = pack_scalars(p if auto else fitted, grid, dev)
                kw = dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu,
                          mode=p.mode, auto_range=auto)
                y, _ = trq_group_mvm_cuda(a, w, s, **kw)
                y_r, _ = trq_group_mvm_ref(a, w, s, **kw)
                y_c = control(torch, a, w, s, **kw)
                kr.append(flips(y, y_r))
                kc.append(flips(y, y_c))
                rc.append(flips(y_r, y_c))
            outs = mm * n * args.seeds
            rec = dict(shape=[mm, k, n], auto_range=auto, seeds=args.seeds,
                       outputs_per_case=mm * n,
                       kernel_vs_plain=kr, kernel_vs_f64=sum(kc),
                       plain_vs_f64=sum(rc),
                       rate_kernel_vs_plain=sum(kr) / outs,
                       rate_kernel_vs_f64=sum(kc) / outs,
                       rate_plain_vs_f64=sum(rc) / outs,
                       max_case=max(kr),
                       cases_over_bar=sum(f > 1e-3 * mm * n for f in kr))
            out.append(rec)
            print(f"{mm:>3}x{k:>5}x{n:>5} {'auto ' if auto else 'given'}: "
                  f"kernel vs plain {sum(kr)} flips in {outs} outputs "
                  f"({sum(kr) / outs:.2e}; per case max {max(kr)}, mean "
                  f"{sum(kr) / args.seeds:.2f}, cases over 1e-3 of the "
                  f"outputs {rec['cases_over_bar']}); against f64: kernel "
                  f"{sum(kc)} ({sum(kc) / outs:.2e}), plain {sum(rc)} "
                  f"({sum(rc) / outs:.2e}); the 1e-3 bar allows "
                  f"{math.floor(1e-3 * mm * n)} a case", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Stress K3 (``xbar_mvm``) and K1's TMA body for a weight-stage race:
launch each kernel thousands of times at whisper-medium's and jamba's
``x_proj`` shapes while a second stream runs copies and matmuls, and count
outputs that differ, bit for bit, from the first launch's.

    PYTHONPATH=src python tools/k3_stage_race.py [--k3-source FILE ...] \\
        [--k1-source FILE ...] [--launches 1500] [--rounds 4] \\
        [--out out/race.json]

Each ``--k3-source`` (default: the checkout's ``csrc/xbar_mvm.cu``) and
each ``--k1-source`` (default: ``csrc/trq_group_mvm.cu``) is built with the
package's nvcc flags into ``$TMPDIR`` and run through the package's
wrapper, sources alternating round by round.  K3 runs at 1,500 rows
(1,024 -> 1,024 / 4,096, 4,096 -> 1,024) and at jamba-v0.1-52b's
``x_proj`` (8,192 -> 288) at 4 and 64 rows, K1's TMA body at decode rows
(whisper-medium's, granite-moe-3b-a800m's and jamba's ``x_proj``, whose
288 columns end K1's 128-column blocks on a ragged 32); each K1 source is
also timed on the device at llama3.2-3b's decode ``w_gate``, granite's
two decode shapes and jamba's decode ``x_proj`` (``chip_smoke.device_ms``:
20 launches, each after an L2 flush, in one CUDA graph, less the
flushes), round by round.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
K3_SHAPES = [(1500, 4096, 1024), (1500, 1024, 1024), (1500, 1024, 4096),
             (4, 8192, 288), (64, 8192, 288)]
K1_SHAPES = [(4, 1024, 1024), (4, 4096, 1024), (4, 1024, 4096),
             (8, 4096, 1024), (4, 1536, 1536), (4, 1536, 512),
             (1, 8192, 288), (4, 8192, 288), (16, 8192, 288)]
# K1 timed: llama3.2-3b's decode w_gate, granite's decode wq/wo and wk/wv,
# jamba's decode x_proj
K1_TIMED = [(4, 3072, 8192), (4, 1536, 1536), (4, 1536, 512),
            (4, 8192, 288)]


def build_fn(source: Path, tmp: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``source``, built with the package's
    flags and bound with the wrapper's ctypes argument list."""
    from repro_torch.kernels import build
    out = Path(tmp) / f"{symbol}_{abs(hash(str(source)))}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(out), str(source)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def other_work(torch, side, big, mm_a):
    with torch.cuda.stream(side):
        for _ in range(4):
            big.mul_(1.0001)
            torch.mm(mm_a, mm_a)


def count_off(torch, launch, launches: int, noise) -> int:
    """Launches of ``launch()`` whose output differs from the first's."""
    base = launch().clone()
    off, outs = 0, []
    for i in range(launches):
        if i % 25 == 0:
            noise()
        outs.append(launch())
        if len(outs) == 50:
            off += sum(int(not torch.equal(o, base)) for o in outs)
            outs = []
    off += sum(int(not torch.equal(o, base)) for o in outs)
    torch.cuda.synchronize()
    return off


def k1_rounds(torch, k1, fns, args, report, gen, dev, p, kw, noise):
    """K1's TMA body from each source in ``fns``, rounds alternating the
    sources: launches off the first one's output at ``K1_SHAPES``, and the
    device time at ``K1_TIMED``."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import L2_BYTES, device_ms
    from repro_torch.kernels.trq_group_mvm import pack_scalars
    s1 = pack_scalars(p, torch.tensor(0.01, device=dev), dev)
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    operands = {}
    for m, k, n in sorted(set(K1_SHAPES) | set(K1_TIMED)):
        a = torch.randn(m, k, generator=gen, device=dev).bfloat16().float()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        operands[(m, k, n)] = (a, w)
    saved = k1._lib
    try:
        for rnd in range(args.rounds):
            order = list(fns.items())
            if rnd % 2:
                order.reverse()
            for name, fn in order:
                k1._lib = lambda fn=fn: fn
                r = report["k1"].setdefault(name, {"ms": {}})
                for shape in K1_SHAPES:
                    a, w = operands[shape]
                    off = count_off(torch, lambda a=a, w=w:
                                    k1.trq_group_mvm_cuda(
                                        a, w, s1, auto_range=True, **kw)[0],
                                    args.launches, noise)
                    key = "x".join(map(str, shape))
                    c = r.setdefault(key, {"launches": 0, "off": 0})
                    c["launches"] += args.launches
                    c["off"] += off
                times = []
                for shape in K1_TIMED:
                    a, w = operands[shape]
                    ms = device_ms(torch, lambda a=a, w=w:
                                   k1.trq_group_mvm_cuda(
                                       a, w, s1, auto_range=True, **kw),
                                   20, flush)
                    key = "x".join(map(str, shape))
                    r["ms"].setdefault(key, []).append(ms)
                    times.append(f"{key} {ms:.4f} ms")
                off = sum(c["off"] for key, c in r.items() if key != "ms")
                print(f"round {rnd} K1 {name}: {off} off so far; device "
                      f"{', '.join(times)}", flush=True)
    finally:
        k1._lib = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--k3-source", action="append", default=None)
    ap.add_argument("--k1-source", action="append", default=None)
    ap.add_argument("--launches", type=int, default=1500)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("k3_stage_race: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.trq import make_params
    from repro_torch.kernels import build
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm import (pack_planes, pack_scalars,
                                              pack_weight_planes)
    build.build(build.KERNELS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    side = torch.cuda.Stream()
    big = torch.empty(256 * 2 ** 20, device=dev)
    mm_a = torch.randn(4096, 4096, device=dev)

    def noise():
        other_work(torch, side, big, mm_a)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    sources = [Path(s) for s in (args.k3_source or
                                 [build.CSRC / "xbar_mvm.cu"])]
    k1_sources = [Path(s) for s in (args.k1_source or
                                    [build.CSRC / "trq_group_mvm.cu"])]
    p = make_params(device=dev, delta_r1=1.0, n_r1=6, n_r2=6, m=4)
    kw = dict(n_r1=6, n_r2=6, m=4, nu=p.nu, mode=p.mode)
    s3 = pack_scalars(p, dev)
    operands = {}
    for m, k, n in K3_SHAPES:
        a = torch.randint(0, 256, (m, k), generator=gen, device=dev)
        w = torch.randint(0, 256, (k, n), generator=gen, device=dev)
        operands[(m, k, n)] = (pack_planes(a.to(torch.int32), 8),
                               pack_weight_planes(w.to(torch.int32), 8))
    report = {"card": card, "k3": {}, "k1": {}}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {str(src): build_fn(src, tmp, "xbar_mvm_launch", k3._ARGTYPES)
               for src in sources}
        k1_fns = {str(src): build_fn(src, tmp, "trq_group_mvm_launch",
                                     k1._ARGTYPES) for src in k1_sources}
        saved = k3._lib
        try:
            for rnd in range(args.rounds):
                order = list(fns.items())
                if rnd % 2:
                    order.reverse()
                for name, fn in order:
                    k3._lib = lambda fn=fn: fn
                    t0 = time.perf_counter()
                    off = sum(count_off(
                        torch, lambda a=a, w=w: k3.xbar_mvm_cuda(
                            a, w, s3, **kw)[0], args.launches, noise)
                        for a, w in operands.values())
                    r = report["k3"].setdefault(name, {"launches": 0,
                                                       "off": 0})
                    r["launches"] += args.launches * len(operands)
                    r["off"] += off
                    print(f"round {rnd} K3 {name}: "
                          f"{args.launches * len(operands)} launches, "
                          f"{off} off ({time.perf_counter() - t0:.1f} s)",
                          flush=True)
        finally:
            k3._lib = saved
        k1_rounds(torch, k1, k1_fns, args, report, gen, dev, p, kw, noise)
    print(json.dumps(report))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

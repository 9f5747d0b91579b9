"""Serving benchmark of the PyTorch/CUDA port (``src/repro_torch``): drives
the paged ``ServeEngine`` over synthetic multi-tenant traces and records
throughput, TTFT and per-request A/D conversions (a port of
``benchmarks/serve_bench.py``).

  PYTHONPATH=src python -m benchmarks.serve_bench_torch --out out/serve.json
      # the card: full-width llama3.2-3b (and rwkv6-7b and whisper-medium
      # in mixed_archs), seeded weights, --backend pallas (default) or
      # bit_exact
  PYTHONPATH=src python -m benchmarks.serve_bench_torch --device cpu --quick \
      --out out/serve_cpu.json
      # the CPU: the smoke config, --backend fake_quant (default)

Scenarios, as in the reference (the units ``benchmarks/check_regression.py``
gates):

* ``shared_prefix_chat`` — chat requests sharing a 40-token system prompt,
  served with prefix reuse on and off, so the A/D-conversion saving of
  hash-consed prefix pages is a recorded number;
* ``long_context`` — few requests with prompts near ``max_len``;
* ``mixed_archs`` — one small trace per architecture family: llama3.2-3b
  (attention), rwkv6-7b (recurrent, no paged leaf, no prefix reuse) and,
  in the full run only as in the reference, whisper-medium (enc-dec: 8
  zero frames per prompt, static cross-KV pages, no prefix reuse).

The JSON keeps the reference's record layout (``{"bench": "serve",
"quick", "scenarios": {...}}``) plus the device, backend and width it ran
at, so ``check_regression`` reads it.  Timings on the CPU measure the CPU;
the deterministic conversion counts are the comparable trajectory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ARCH = "llama3.2-3b"
RECURRENT_ARCH = "rwkv6-7b"
ENCDEC_ARCH = "whisper-medium"
# the reference's mixed_archs families the port does not serve yet
PENDING_ARCHS: dict = {}


def build(arch: str = ARCH, backend: str = "fake_quant", device="cuda",
          weights=None):
    """One compiled and warmed Runtime per (arch, backend): full width on
    the card (bf16 parameters, as ``launch.serve`` serves), the smoke
    config on the CPU (f32 parameters, as the reference bench).
    ``weights(cfg)`` returns the state dict; default: the port's seeded
    init.  A prefill and a decode run off the record, so building the
    kernels at first use and warming the libraries stay out of the first
    scenario's TTFT."""
    from repro_torch import runtime
    from repro_torch.launch.serve import frames_stub
    from repro_torch.models.registry import get_config, init

    device = runtime.resolve_device(device)
    smoke = device.type == "cpu"
    cfg = get_config(arch, smoke=smoke).replace(remat="none",
                                                pim_backend=backend)
    if not smoke:
        cfg = cfg.replace(param_dtype="bfloat16")
    state = weights(cfg) if weights is not None else \
        init(cfg, seed=0, device=device)
    rt = runtime.compile(cfg, state, device=device)
    (_, cache), _ = rt.prefill(np.zeros((1, 16), np.int32),
                               frames_stub(cfg)(1, 16), max_len=128)
    rt.decode(np.zeros((1, 1), np.int32), cache)
    return cfg, rt


def serve(built, prompts, *, max_new: int, max_batch: int = 2,
          max_len: int = 128, reuse: bool = True, block_size: int = 16):
    """Serve ``prompts`` greedily (an encoder-decoder's prefills get 8
    zero frames, as the reference bench's); returns (record, engine)."""
    from repro_torch.launch.serve import frames_stub
    from repro_torch.serve import ServeEngine

    cfg, rt = built
    eng = ServeEngine(rt, max_batch=max_batch, max_len=max_len, paged=True,
                      extra_inputs=frames_stub(cfg), block_size=block_size,
                      prefix_reuse=reuse)
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    eng.run()
    if rt.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    return {
        "requests": st["requests"],
        "decode_tokens": st["decode_tokens"],
        "tokens_per_s": st["tokens_per_s"],
        "mean_ttft_s": st["mean_ttft_s"],
        "total_ad_ops": st["total_ad_ops"],
        "prefill_ad_ops": st["prefill_ad_ops"],
        "mean_ad_ops_per_request": st["mean_ad_ops_per_request"],
        "mean_ad_energy_pj_per_request": st["mean_ad_energy_pj_per_request"],
        "reused_prompt_tokens": st["reused_prompt_tokens"],
        "wall_s": wall,
    }, eng


def chat_prompts(vocab: int, quick: bool) -> list:
    """The shared-prefix trace: a 40-token prefix plus a 12-token tail."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, 40)
    return [np.concatenate([prefix, rng.integers(0, vocab, 12)])
            for _ in range(4 if quick else 8)]


def shared_prefix_chat(built, quick: bool, weights=None) -> dict:
    prompts = chat_prompts(built[0].vocab_size, quick)
    max_new = 4 if quick else 8
    with_reuse, eng_on = serve(built, prompts, max_new=max_new, reuse=True)
    no_reuse, eng_off = serve(built, prompts, max_new=max_new, reuse=False)
    if not with_reuse["total_ad_ops"] < no_reuse["total_ad_ops"]:
        raise AssertionError("prefix reuse must strictly reduce total A/D "
                             "conversions")
    on = [r.generated for r in sorted(eng_on.finished, key=lambda r: r.uid)]
    off = [r.generated for r in sorted(eng_off.finished,
                                       key=lambda r: r.uid)]
    with_reuse["no_reuse_total_ad_ops"] = no_reuse["total_ad_ops"]
    with_reuse["reuse_ad_ops_saved_frac"] = \
        1.0 - with_reuse["total_ad_ops"] / no_reuse["total_ad_ops"]
    with_reuse["no_reuse_tokens_per_s"] = no_reuse["tokens_per_s"]
    with_reuse["no_reuse_mean_ttft_s"] = no_reuse["mean_ttft_s"]
    # a reading, not a gate: the suffix-only prefill quantizes with
    # suffix-local dynamic scales and a decode batch shares its scales, so
    # reuse can move greedy tokens on the quantized datapaths (in the
    # reference too)
    with_reuse["reuse_tokens_identical"] = on == off
    return with_reuse


def long_context(built, quick: bool, weights=None) -> dict:
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, built[0].vocab_size, 100)
               for _ in range(2 if quick else 4)]
    return serve(built, prompts, max_new=4 if quick else 8, max_len=128,
                 reuse=True)[0]


def mixed_prompts(vocab: int) -> list:
    """The mixed-archs trace: prompts of 12, 24 and 7 tokens."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n) for n in (12, 24, 7)]


def mixed_archs(built, quick: bool, weights=None) -> dict:
    """The reference's scenario: the same trace on ``built`` (llama), on
    rwkv6-7b and, in the full run, on whisper-medium, each built on the
    same backend and device with ``weights`` (one at a time: an arch's
    weights are freed before the next is built); the aggregates are over
    the archs served here."""
    _, rt = built
    out = {"archs": {}}
    archs = [None, RECURRENT_ARCH] + ([] if quick else [ENCDEC_ARCH])
    for arch in archs:
        b = built if arch is None else build(arch, rt.backend, rt.device,
                                             weights)
        prompts = mixed_prompts(b[0].vocab_size)
        out["archs"][b[0].name] = serve(b, prompts,
                                        max_new=3 if quick else 6,
                                        max_len=64)[0]
        del b
    if not quick:
        out["pending_archs"] = dict(PENDING_ARCHS)
    recs = out["archs"].values()
    out["tokens_per_s"] = float(np.mean([r["tokens_per_s"] for r in recs]))
    out["mean_ad_ops_per_request"] = float(np.mean(
        [r["mean_ad_ops_per_request"] for r in recs]))
    return out


# each takes (built, quick, weights); ``weights`` builds any other arch the
# scenario serves
SCENARIOS = {
    "shared_prefix_chat": shared_prefix_chat,
    "long_context": long_context,
    "mixed_archs": mixed_archs,
}


def run(quick: bool = False, only=None, device="cuda",
        backend: str = None, weights=None) -> dict:
    """Every scenario (or those in ``only``) on one Runtime; returns the
    JSON-ready report.  ``backend`` defaults to ``pallas`` (the K1 kernel)
    on the card and to the reference bench's ``fake_quant`` on the CPU."""
    backend = backend or ("pallas" if str(device).startswith("cuda")
                          else "fake_quant")
    built = build(ARCH, backend, device, weights)
    rt = built[1]
    kind = "cpu"
    if rt.device.type == "cuda":
        import torch
        kind = torch.cuda.get_device_name(rt.device)
    report = {"bench": "serve", "quick": quick, "device": kind,
              "backend": backend, "arch": built[0].name,
              "width": "smoke" if rt.device.type == "cpu" else "full",
              "scenarios": {}}
    for name, fn in SCENARIOS.items():
        if only and name not in only:
            continue
        t0 = time.time()
        report["scenarios"][name] = fn(built, quick, weights)
        report["scenarios"][name]["suite_wall_s"] = time.time() - t0
        print(f"serve_bench_torch.{name},"
              f"{report['scenarios'][name]['suite_wall_s'] * 1e6:.0f},ok")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list of scenario names")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="PIM backend (default: pallas on the card, "
                         "fake_quant on the CPU)")
    ap.add_argument("--out", required=True,
                    help="where to write the JSON report")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    report = run(args.quick, only, args.device, args.backend)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

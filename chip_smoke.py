#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels build for ``sm_90a``), ``nvcc``
and the checkout's ``src/``; exits nonzero without them.  Phases, each of
which fails the run on any error:

1. build   every hand-written kernel from ``src/repro_torch/kernels/csrc``
           with nvcc (one process per source, all at once), timed;
2. K1      ``trq_group_mvm`` against its plain PyTorch version on the card:
           exact on integer-valued inputs, and on random floats at the
           main path's shapes within the float bar (rtol=atol=1e-5 on at
           least 99.9 % of elements, any other element within one coarse
           quantizer step per 128-row group: a boundary flip from another
           f32 summation order); median times beside the bound;
3. serve   full-width llama3.2-3b (28 layers, bf16, seeded random weights)
           on the prepared ``pallas`` datapath through ``runtime.compile``
           and the paged ``ServeEngine``: 8 requests sharing a 48-token
           prefix, 16 new tokens each, greedy.  Launch counts are reset
           just before and read just after; every projection of every
           forward must have launched K1, and the A/D-op total must equal
           its closed form (every conversion costs nu + n_r = 7 ops);
4. check   one full-width prefill on ``fake_quant`` (the plain tensor
           version of the same math) against ``pallas``: finite logits,
           equal A/D ops, and a relative L2 distance within 3x that of a
           control (``fake_quant`` against itself with f64 partial sums),
           or 1e-2 if that is larger.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "llama3.2-3b"
N_LAYERS = 28
PROJ_PER_LAYER = 7                 # wq wk wv wo w_gate w_up w_down
MAIN_SHAPES = [(m, k, n) for m in (4, 64)
               for k, n in ((3072, 3072), (3072, 1024), (3072, 8192),
                            (8192, 3072))]
HEADLINE_SHAPE = (4, 3072, 8192)   # decode w_gate / w_up
# registers of tests/test_kernels.py::PARAM_GRID with n_r1 != n_r2
R1_REGS = [dict(n_r1=2, n_r2=6, m=1, bias=0.0),
           dict(n_r1=3, n_r2=5, m=4, bias=3.0)]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
FLOAT_TOL = 1e-5
MAX_FLIP_FRACTION = 1e-3
LOGIT_CTRL_FACTOR = 3.0           # phase 4: pallas within 3x the control
LOGIT_REL_FLOOR = 1e-2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def import_port():
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch
    where = os.path.dirname(os.path.abspath(repro_torch.__file__))
    if not where.startswith(os.path.join(HERE, "src")):
        raise RuntimeError(f"repro_torch imported from {where}, not from "
                           f"this checkout")
    return repro_torch


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def median_ms(torch, fn, reps: int, flush) -> float:
    """Median of per-launch CUDA-event times, the L2 cache flushed before
    every launch (the main path streams each layer's weights cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(m: int, k: int, n: int):
    """Least time for one call: each input read once and the output written
    once at the HBM rate, or the 2MKN f32 multiply-adds at the f32 rate,
    whichever is larger."""
    byts = 4 * (m * k + k * n + m * n) + 4 * 3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_phase(torch, rec: dict, device: str = "cuda") -> None:
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.trq_group_mvm import pack_scalars
    from repro_torch.kernels.trq_group_mvm.kernel import trq_group_mvm_cuda
    from repro_torch.kernels.trq_group_mvm.ref import trq_group_mvm_ref
    from repro_torch.pim.backend import _dynamic_scales, grid_scale
    from repro_torch.pim.crossbar import auto_range_fit

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def regs_of(p):
        return dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)

    # -- exact: integer operands, power-of-two grid and steps --------------
    for (m, k, n), rk in [((64, 3072, 1024), dict(n_r1=6, n_r2=6, m=4)),
                          ((3, 300, 130), dict(n_r1=6, n_r2=6, m=4)),
                          *[((64, 3072, 1024), r) for r in R1_REGS],
                          *[((3, 300, 130), r) for r in R1_REGS]]:
        a = torch.randint(-8, 9, (m, k), generator=gen, device=dev).float()
        w = torch.randint(-8, 9, (k, n), generator=gen, device=dev).float()
        p = make_params(delta_r1=16.0, signed=True, device=dev, **rk)
        s = pack_scalars(p, torch.tensor(0.5, device=dev), dev)
        y, ops = trq_group_mvm_cuda(a, w, s, **regs_of(p))
        y_r, ops_r = trq_group_mvm_ref(a, w, s, **regs_of(p))
        torch.cuda.synchronize()
        if not torch.equal(y, y_r) or int(ops) != int(ops_r):
            raise AssertionError(
                f"K1 not exact on integer inputs {m}x{k}x{n} {rk}: max err "
                f"{float((y - y_r).abs().max())}, ops {int(ops)} vs "
                f"{int(ops_r)}")
        log(f"  exact  {m:>3}x{k:>5}x{n:>5} {rk}: y equal, ops {int(ops)}")

    # -- float: the main path's operands and auto-ranged registers ---------
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    cases = [(shape, dict(n_r1=6, n_r2=6, m=4)) for shape in MAIN_SHAPES]
    cases += [((64, 3072, 1024), r) for r in R1_REGS]
    cases += [((3, 300, 130), dict(n_r1=6, n_r2=6, m=4))]
    timed = set(MAIN_SHAPES)
    for (m, k, n), rk in cases:
        # bf16-valued operands, as the serving path widens them
        a = torch.randn(m, k, generator=gen, device=dev).bfloat16().float()
        w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
             ).bfloat16().float()
        a_s, w_s = _dynamic_scales(a, w, None, None)
        grid = grid_scale(a_s, w_s, 1.0, dev)
        p = auto_range_fit(a, w, make_params(signed=True, device=dev, **rk),
                           grid)
        s = pack_scalars(p, grid, dev)
        y, ops = trq_group_mvm_cuda(a, w, s, **regs_of(p))
        y_r, ops_r = trq_group_mvm_ref(a, w, s, **regs_of(p))
        torch.cuda.synchronize()
        g = -(-k // 128)
        err = (y - y_r).abs()
        close = err <= FLOAT_TOL + FLOAT_TOL * y_r.abs()
        flips = int((~close).sum())
        step = float(p.delta_r2 * grid)              # one coarse step
        worst = float(err.max())
        d_ops = abs(int(ops) - int(ops_r))
        ok = (flips <= MAX_FLIP_FRACTION * y.numel()
              and worst <= g * step * (1 + FLOAT_TOL) + FLOAT_TOL
              and d_ops <= flips * g * abs(p.n_r2 - p.n_r1)
              and bool(torch.isfinite(y).all()))
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
        rec["flips"] += flips
        rec["elements"] += y.numel()
        line = (f"  float  {m:>3}x{k:>5}x{n:>5} {rk}: flips {flips}/"
                f"{y.numel()}, max err {worst:.3e} (coarse step "
                f"{step:.3e}), ops {int(ops)} vs {int(ops_r)}")
        if not ok:
            raise AssertionError("K1 outside the float bar:" + line)
        if (m, k, n) in timed and rk["n_r1"] == 6:
            kw = regs_of(p)
            ms = median_ms(torch, lambda: trq_group_mvm_cuda(a, w, s, **kw),
                           20, flush)
            plain = median_ms(torch, lambda: trq_group_mvm_ref(a, w, s, **kw),
                              5, flush)
            b, by = bound(m, k, n)
            rec["shapes"].append(dict(shape=[m, k, n], ms=ms, plain_ms=plain,
                                      bound_ms=b, bound_by=by))
            line += (f"; {ms:.4f} ms (plain {plain:.4f} ms, bound {b:.4f} ms"
                     f" by {by})")
        log(line)


# ---------------------------------------------------------------------------
# phases 3 and 4: full-width serving
# ---------------------------------------------------------------------------

def projection_shapes(cfg):
    """(K, N) of wq, wk, wv, wo, w_gate, w_up, w_down."""
    hd, d, f = cfg.hd, cfg.d_model, cfg.d_ff
    return [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
            (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d), (d, f),
            (d, f), (f, d)]


def conversions_per_token(cfg) -> int:
    """A/D conversions one token costs in one layer: N x ceil(K/128) per
    projection."""
    return sum(n * -(-k // 128) for k, n in projection_shapes(cfg))


@contextlib.contextmanager
def f64_partial_sums(torch):
    """Run the plain fake-quant datapath with its per-group partial sums
    accumulated in f64 and rounded once to f32."""
    from repro_torch.pim import crossbar
    orig = crossbar._group_psums

    def psums(a_g, w_g):
        return torch.einsum("...gx,gxn->...gn", a_g.double(),
                            w_g.double()).float()
    crossbar._group_psums = psums
    try:
        yield
    finally:
        crossbar._group_psums = orig


def serve_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch import runtime
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.models.registry import init
    from repro_torch.serve import ServeEngine
    import numpy as np

    t = cfg.trq
    assert (t.n_r1, t.n_r2, t.auto_range) == (6, 6, True)
    t0 = time.perf_counter()
    state = init(cfg, seed=0, device=device)
    rt = runtime.compile(cfg, state, device=device)
    del state
    torch.cuda.synchronize()
    log(f"  compiled {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, {len(rt.plan)} layer "
        f"plans on {rt.backend!r} in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    # warm the libraries (cuBLAS handles, the kernel's module) off the record
    (_, cache), _ = rt.prefill(np.zeros((1, 16), np.int32), max_len=256)
    rt.decode(np.zeros((1, 1), np.int32), cache)
    torch.cuda.synchronize()

    engine = ServeEngine(rt, max_batch=4, max_len=256, block_size=16)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 16)])
               for _ in range(8)]

    k1.LAUNCHES = 0
    calls0 = rt.forward_calls
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, max_new_tokens=16)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.LAUNCHES
    calls = rt.forward_calls - calls0
    rec["launches"] = launches

    st = engine.stats()
    for r in sorted(done, key=lambda r: r.uid):
        log(f"  req {r.uid}: reused {r.reused_tokens} prompt tokens, "
            f"ttft {1e3 * (r.first_token_t - r.submit_t):.1f} ms, ad_ops "
            f"{r.ad_ops:.0f} (prefill {r.prefill_ad_ops:.0f}), tokens "
            f"{list(r.generated)}")
    log(f"  served {st['requests']} requests, {st['decode_tokens']} tokens "
        f"in {wall:.2f} s: {st['tokens_per_s']:.2f} tok/s, mean ttft "
        f"{1e3 * st['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{st['total_ad_ops']:.0f}, {calls} forwards, K1 launches "
        f"{launches}")

    # the main path ran K1 for every projection of every forward
    want_launches = PROJ_PER_LAYER * cfg.n_layers * calls
    if launches != want_launches or calls == 0:
        raise AssertionError(f"K1 launched {launches} times for {calls} "
                             f"forwards; expected {want_launches}")
    if len(done) != 8 or any(len(r.generated) != 16 or not all(
            0 <= t < cfg.vocab_size for t in r.generated) for r in done):
        raise AssertionError("engine did not return 16 in-vocab tokens for "
                             "each of the 8 requests")
    if sorted(r.reused_tokens for r in done) != [0] + [48] * 7:
        raise AssertionError("prefix reuse did not serve the shared prefix")
    # closed form of the op total: with n_r1 == n_r2 every conversion costs
    # nu + n_r = 7 ops; prefills convert their suffix tokens, every decode
    # step converts all max_batch rows
    per_token = 7 * cfg.n_layers * conversions_per_token(cfg)
    prefill_rows = sum(64 - r.reused_tokens for r in done)
    decode_rows = engine.max_batch * (calls - len(done))
    want = per_token * (prefill_rows + decode_rows)
    if st["total_ad_ops"] != want:
        raise AssertionError(f"A/D ops {st['total_ad_ops']} != closed form "
                             f"{want}")
    log(f"  A/D ops equal the closed form {want} "
        f"({prefill_rows} prefill rows, {decode_rows} decode rows)")
    serve = dict(tokens_per_s=st["tokens_per_s"],
                 mean_ttft_ms=1e3 * st["mean_ttft_s"],
                 total_ad_ops=st["total_ad_ops"], forwards=calls,
                 wall_s=wall)

    # one forward of each kind, host clock around a synchronised call; K1's
    # share from phase 2's per-call times (M=4 decode, M=64 prefill)
    def wall_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
        return sorted(times)[reps // 2]

    dec_cache = rt.init_cache(engine.max_batch, 256)
    dec_toks = np.zeros((engine.max_batch, 1), np.int32)
    serve["decode_step_ms"] = wall_ms(lambda: rt.decode(dec_toks, dec_cache))
    serve["prefill64_ms"] = wall_ms(
        lambda: rt.prefill(prompts[0][None], max_len=256))
    per_call = {tuple(x["shape"]): x["ms"] for x in rec["shapes"]}
    for key, m in (("decode_step_k1_ms", 4), ("prefill64_k1_ms", 64)):
        if per_call:
            serve[key] = cfg.n_layers * sum(
                per_call[(m, k, n)] for k, n in projection_shapes(cfg))
    log(f"  one decode step (batch {engine.max_batch}) "
        f"{serve['decode_step_ms']:.1f} ms, one 64-token prefill "
        f"{serve['prefill64_ms']:.1f} ms; K1's part from phase 2: "
        f"{serve.get('decode_step_k1_ms', 0):.1f} ms and "
        f"{serve.get('prefill64_k1_ms', 0):.1f} ms")

    # -- phase 4: fake_quant (plain tensor ops) against pallas (K1) --------
    # Two exact implementations of one quantized network differ only where
    # an f32 partial sum lands on the other side of a quantizer step, and
    # 28 random bf16 layers amplify each such flip.  The bar is therefore
    # relative to a control: the plain version against itself with its
    # partial sums accumulated in f64 (another rounding of the same math).
    log("phase 4: full-width prefill, fake_quant against pallas")
    toks = prompts[0][None].astype(np.int32)
    (l_p, _), rep_p = rt.prefill(toks, max_len=256)
    rt_fq = rt.with_overrides(backend="fake_quant")
    (l_f, _), rep_f = rt_fq.prefill(toks, max_len=256)
    with f64_partial_sums(torch):
        (l_c, _), rep_c = rt_fq.prefill(toks, max_len=256)
    torch.cuda.synchronize()

    def rel_l2(x, y):
        return float((x - y).norm() / y.norm())

    rel, ctrl = rel_l2(l_p, l_f), rel_l2(l_c, l_f)
    bar = max(LOGIT_CTRL_FACTOR * ctrl, LOGIT_REL_FLOOR)
    same_top = bool((l_p.argmax(-1) == l_f.argmax(-1)).all())
    log(f"  logits {tuple(l_p.shape)}: pallas vs fake_quant relative L2 "
        f"{rel:.3e} (bar {bar:.3e}); control (fake_quant with f64 partial "
        f"sums) {ctrl:.3e}; pallas vs control {rel_l2(l_p, l_c):.3e}; "
        f"same argmax {same_top}; ad_ops {rep_p.total():.0f} vs "
        f"{rep_f.total():.0f} vs {rep_c.total():.0f}")
    if tuple(l_p.shape) != (1, cfg.vocab_size) or not bool(
            torch.isfinite(l_p).all()):
        raise AssertionError("pallas logits not finite or misshapen")
    if rel > bar or not rep_p.total() == rep_f.total() == rep_c.total():
        raise AssertionError("pallas and fake_quant disagree at full width")
    serve.update(logit_rel_l2=rel, control_rel_l2=ctrl, same_argmax=same_top)
    return serve


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    import_port()
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    log("phase 1: build")
    t0 = time.perf_counter()
    logs = build.build(build.KERNELS, force=True)
    log(f"  built {', '.join(build.KERNELS)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")

    rec = dict(name="trq_group_mvm", route="cuda",
               source="src/repro_torch/kernels/csrc/trq_group_mvm.cu",
               replaces="src/repro/kernels/trq_group_mvm/kernel.py:57",
               launches=0, max_abs_err=0.0, flips=0, elements=0, shapes=[])
    log("phase 2: trq_group_mvm against its plain version")
    k1_phase(torch, rec)
    log("phase 3: serve full-width llama3.2-3b on pallas")
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH).replace(param_dtype="bfloat16",
                                   pim_backend="pallas", remat="none")
    assert cfg.n_layers == N_LAYERS and cfg.d_model == 3072
    serve = serve_phase(torch, rec, cfg)

    head = next(s for s in rec["shapes"]
                if tuple(s["shape"]) == HEADLINE_SHAPE)
    rec.update(shape=head["shape"], ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=head["bound_ms"], bound_by=head["bound_by"],
               library_ms=None)
    log(json.dumps({"serve": serve}))
    log(json.dumps({"kernels": [rec]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

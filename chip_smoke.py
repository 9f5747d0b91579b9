#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels build for ``sm_90a``), ``nvcc``
and the checkout's ``src/``; exits nonzero without them.  Phases, each of
which fails the run on any error:

1. build   every hand-written kernel from ``src/repro_torch/kernels/csrc``
           with nvcc (one process per source, all at once), timed;
2. K1      ``trq_group_mvm`` against its plain PyTorch version on the card,
           with registers given and auto-ranged (the kernel's fused fit)
           and with bf16 and f32 weights, at M = 1, 4, 8, 16, 64 on the four
           projection shapes, ragged 3 x 300 x 130 and 5 x 700 x 136 (the
           TMA body's zero-filled edges): exact on integer-
           valued inputs, and on bf16-valued random floats within the
           float bar (rtol=atol=1e-5 on at least 99.9 % of elements, any
           other element within one coarse quantizer step per 128-row
           group: a boundary flip from another f32 summation order), and
           on the ``w_gate`` of one 2,048-token prefill; times of the whole
           call (both passes) at M = 4, 16, 64 and that prefill beside the
           bound (bf16 weights read at 2 bytes each): the device time (20
           launches, each after an L2 flush, replayed as one CUDA graph,
           less the flushes), the time of one call as a caller sees it,
           host work included, and ``torch.matmul`` on the same bf16
           operands as a yardstick (another function: no quantizer);
3. serve   full-width llama3.2-3b (28 layers, bf16, seeded random weights)
           on the prepared ``pallas`` datapath through ``runtime.compile``
           and the paged ``ServeEngine``: 8 requests sharing a 48-token
           prefix, 16 new tokens each, greedy.  Launch counts are reset
           just before and read just after; every projection of every
           forward must have launched K1, and the A/D-op total must equal
           its closed form (every conversion costs nu + n_r = 7 ops); the
           memory allocated after compile; a ``torch.profiler`` reading of
           one batch-4 decode step and one 64-token prefill (device time
           by kernel and by span, device-idle share: a reading, not a
           check; "not measured" when the profiler sees no device time);
4. check   one full-width prefill on ``fake_quant`` (the plain tensor
           version of the same math) against ``pallas``: finite logits,
           equal A/D ops, and a relative L2 distance within 3x that of a
           control (``fake_quant`` against itself with f64 partial sums),
           or 1e-2 if that is larger;
5. K2      ``trq_quant`` against its plain version on the card, registers of
           ``tests/test_kernels.py::PARAM_GRID`` in signed, unsigned and
           uniform modes, f32 and f16 input: q bitwise equal (atol=0) and
           ops equal; timed at the calibration shape (65,536 samples) and
           at 2^26 elements, beside the bound by bytes (4 B read, 8 B
           written per element);
6. K3      ``xbar_mvm`` against its plain version at the eight projection
           shapes of phase 2 and ragged 3 x 300 x 130, with the default
           registers, a fractional step and the lossless mode: op counts
           (total and per output) exactly equal everywhere; y bitwise equal
           wherever the f64 control's shift-add stays below 2^24 units of
           the quantizer's grid, and elsewhere, for kernel and plain
           version alike, within the recursive-summation bound
           64 G u |y| (u = 2^-24) of the f64 control; timed beside the
           bound (packed bytes at 3.35 TB/s or the 0/1 products at the
           1,979 TOP/s int8 rate);
7. bit_exact  full-width llama3.2-3b on the prepared ``bit_exact``
           datapath, the phase-3 trace: every projection of every forward
           launched K3, and the A/D ops equal the closed form (k_i k_w
           ceil(K/128) N conversions per token row of a projection, 7 ops
           each); then one 64-token prefill on the plain version of K3:
           relative L2 of the logits within 1e-2, the same argmax, equal
           A/D ops;
8. calibrate  Algorithm 1 on the card: one prefill of the shared prefix
           on a ``bit_exact`` Runtime with per-depth names
           (``scan_layers=False``); forward hooks take each of the 196
           projections' inputs, ``collect_bl_samples`` turns them into the
           layer's bit-line sums, ``calibrate_layer(n_max=7)`` scores every
           candidate through K2; on the 14 projections of the first and
           last layer, scoring with K2's plain version must pick identical
           registers; the calibrated QuantState then serves the trace and
           its A/D ops are read against the uniform 8-bit baseline.

Kernel launch counts are reset just before each main path (phase 3 for
K1, phase 7 for K3, the calibration of phase 8 for K2) and read just
after; launches that compare a kernel with its plain version do not count.
The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

builds the kernels and runs only the profile of phase 3, on any checkout
of the port (the parent commit's too, for a before-and-after in one call).
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "llama3.2-3b"
N_LAYERS = 28
PROJ_PER_LAYER = 7                 # wq wk wv wo w_gate w_up w_down
PROJ_KN = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
MAIN_SHAPES = [(m, k, n) for m in (4, 64) for k, n in PROJ_KN]
K1_MS = (1, 4, 8, 16, 64)          # phase 2: rows checked (every m-tile)
K1_TIMED_MS = (4, 16, 64, 2048)    # decode, prefill_cont, prefill, long
LONG_PREFILL = (2048, 3072, 8192)  # w_gate of a 2,048-token prefill
TMA_RAGGED = (5, 700, 136)         # ragged M, K, N on K1's TMA body
HEADLINE_SHAPE = (4, 3072, 8192)   # decode w_gate / w_up
PARAM_GRID = [dict(n_r1=4, n_r2=4, m=3, bias=0.0),    # tests/test_kernels.py
              dict(n_r1=2, n_r2=6, m=1, bias=0.0),
              dict(n_r1=3, n_r2=5, m=4, bias=3.0),
              dict(n_r1=7, n_r2=7, m=0, bias=0.0)]
R1_REGS = [r for r in PARAM_GRID if r["n_r1"] != r["n_r2"]]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
FLOAT_TOL = 1e-5
MAX_FLIP_FRACTION = 1e-3
LOGIT_CTRL_FACTOR = 3.0           # phase 4: pallas within 3x the control
LOGIT_REL_FLOOR = 1e-2
INT8_OPS_PER_S = 1979e12           # int8 tensor cores, dense (data sheet)
CALIB_SAMPLES = 65536              # core.calibrate.MAX_CALIB_SAMPLES
K2_BIG = 2 ** 26
# K3 registers: (name, make_params kwargs or None for lossless, the grid
# unit every quantized bit-line sum is a multiple of)
K3_REGS = [("default", dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4), 1.0),
           ("fractional", dict(delta_r1=0.75, n_r1=4, n_r2=5, m=3,
                               bias=1.0), 0.25),
           ("lossless", None, 1.0)]
TRACE_BATCH = 4                    # the engine's max batch in the trace
SLICES = 8 * 8                     # k_i x k_w bit-line conversions per group
BIT_EXACT_REL_BAR = 1e-2           # phase 7: plain vs K3 logits
CHECKED_DEPTHS = (0, N_LAYERS - 1)  # phase 8: plain-scored layers


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

def call_ms(torch, fn, reps: int, flush) -> float:
    """Median time of one call as a caller sees it: CUDA events around the
    call, the L2 cache flushed before each (the main path streams each
    layer's weights cold).  When the wrapper's host work outlasts the
    kernel, this measures the host."""
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


def device_ms(torch, fn, reps: int, flush) -> float:
    """Device time of one call: ``reps`` calls, each after an L2 flush,
    captured in one CUDA graph and replayed (no host work between the
    launches), less a replay of the flushes alone; medians of 5 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)

    def replay_ms(g) -> float:
        g.replay()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[2]

    t = (replay_ms(graphs[0]) - replay_ms(graphs[1])) / reps
    del graphs
    torch.cuda.synchronize()
    return t


def bound(m: int, k: int, n: int, w_bytes: int = 2):
    """Least time for one call: each operand read once as the kernel reads
    it (f32 activations, ``w_bytes`` a weight: 2 for the bf16 image of the
    serving path) and the output written once at the HBM rate, or the 2MKN
    f32 multiply-adds at the f32 rate, whichever is larger."""
    byts = 4 * m * k + w_bytes * k * n + 4 * m * n + 4 * 3 + 8
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_phase(torch, rec: dict, device: str = "cuda") -> None:
    """K1 against its plain version, registers given and auto-ranged, bf16
    and f32 weights; timed at the main path's shapes (M = 4, 16, 64) and
    at one long prefill, where the (M, G, N) scratch is largest."""
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.trq_group_mvm import pack_scalars
    from repro_torch.kernels.trq_group_mvm.kernel import trq_group_mvm_cuda
    from repro_torch.kernels.trq_group_mvm.ref import trq_group_mvm_ref
    from repro_torch.pim.backend import _dynamic_scales, grid_scale
    from repro_torch.pim.crossbar import auto_range_fit

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    wdtypes = (torch.bfloat16, torch.float32)

    def regs_of(p):
        return dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)

    # -- exact: integer operands, power-of-two grid and steps --------------
    default = dict(n_r1=6, n_r2=6, m=4)
    cases = [((m, k, n), default) for m in K1_MS for k, n in PROJ_KN]
    cases += [((3, 300, 130), default), (TMA_RAGGED, default)]
    cases += [(shape, r) for shape in ((64, 3072, 1024), (3, 300, 130))
              for r in R1_REGS]
    n_exact = 0
    for (m, k, n), rk in cases:
        a = torch.randint(-8, 9, (m, k), generator=gen, device=dev).float()
        w_int = torch.randint(-8, 9, (k, n), generator=gen, device=dev)
        for wdt in wdtypes:
            w = w_int.to(wdt)                   # exact in bf16 too
            for auto in (False, True):
                p = make_params(delta_r1=1.0 if auto else 16.0, signed=True,
                                device=dev, **rk)
                s = pack_scalars(p, torch.tensor(0.5, device=dev), dev)
                kw = dict(regs_of(p), auto_range=auto)
                y, ops = trq_group_mvm_cuda(a, w, s, **kw)
                y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
                torch.cuda.synchronize()
                if not torch.equal(y, y_r) or int(ops) != int(ops_r):
                    raise AssertionError(
                        f"K1 not exact on integer inputs {m}x{k}x{n} {rk} "
                        f"{wdt} auto_range={auto}: max err "
                        f"{float((y - y_r).abs().max())}, ops {int(ops)} vs "
                        f"{int(ops_r)}")
                n_exact += 1
    log(f"  exact: {n_exact} integer cases (M in {K1_MS} at the four "
        f"projection shapes, 3x300x130 and {TMA_RAGGED}; bf16 and f32 "
        f"weights; registers "
        f"given and auto-ranged): y bitwise equal, ops equal")

    # -- float: bf16-valued operands, registers given and auto-ranged ------
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    cases = [((m, k, n), default, wdt, auto)
             for m in K1_MS for k, n in PROJ_KN for wdt in wdtypes
             for auto in (False, True)]
    cases += [((64, 3072, 1024), r, torch.bfloat16, True) for r in R1_REGS]
    cases += [(shape, default, wdt, True) for wdt in wdtypes
              for shape in ((3, 300, 130), TMA_RAGGED)]
    cases += [(LONG_PREFILL, default, torch.bfloat16, True)]
    for (m, k, n), rk, wdt, auto in cases:
        a = torch.randn(m, k, generator=gen, device=dev).bfloat16().float()
        w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
             ).to(torch.bfloat16).to(wdt)
        a_s, w_s = _dynamic_scales(a, w.float(), None, None)
        grid = grid_scale(a_s, w_s, 1.0, dev)
        p = make_params(signed=True, device=dev, **rk)
        fitted = auto_range_fit(a, w.float(), p, grid)
        s = pack_scalars(p if auto else fitted, grid, dev)
        kw = dict(regs_of(p), auto_range=auto)
        y, ops = trq_group_mvm_cuda(a, w, s, **kw)
        y_r, ops_r = trq_group_mvm_ref(a, w, s, **kw)
        torch.cuda.synchronize()
        g = -(-k // 128)
        err = (y - y_r).abs()
        close = err <= FLOAT_TOL + FLOAT_TOL * y_r.abs()
        flips = int((~close).sum())
        step = float(fitted.delta_r2 * grid)         # one coarse step
        worst = float(err.max())
        d_ops = abs(int(ops) - int(ops_r))
        ok = (flips <= MAX_FLIP_FRACTION * y.numel()
              and worst <= g * step * (1 + FLOAT_TOL) + FLOAT_TOL
              and d_ops <= flips * g * abs(p.n_r2 - p.n_r1)
              and bool(torch.isfinite(y).all()))
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
        rec["flips"] += flips
        rec["elements"] += y.numel()
        wname = "bf16" if wdt == torch.bfloat16 else "f32"
        line = (f"  float  {m:>3}x{k:>5}x{n:>5} {wname} "
                f"{'auto ' if auto else 'given'} {rk}: flips {flips}/"
                f"{y.numel()}, max err {worst:.3e} (coarse step "
                f"{step:.3e}), ops {int(ops)} vs {int(ops_r)}")
        if not ok:
            raise AssertionError("K1 outside the float bar:" + line)
        if (k, n) in PROJ_KN and m in K1_TIMED_MS and auto and \
                wdt == torch.bfloat16 and rk is default:
            kern = lambda: trq_group_mvm_cuda(a, w, s, **kw)  # noqa: E731
            ms = device_ms(torch, kern, 20, flush)
            per_call = call_ms(torch, kern, 20, flush)
            plain = device_ms(torch, lambda: trq_group_mvm_ref(a, w, s, **kw),
                              5, flush)
            a16 = a.bfloat16()
            mm_ms = device_ms(torch, lambda: torch.matmul(a16, w), 20, flush)
            # the two passes' device times in one cold call
            prof = profile_forward(torch, lambda: (flush.zero_(), kern()))
            passes = {}
            for t in prof.get("top_kernels", []):
                hit = re.search(r"trq_group_mvm_\w+(<[^>]*>)?", t["name"])
                if hit:
                    passes[hit.group(0)] = t["ms"]
            b, by = bound(m, k, n)
            b32, _ = bound(m, k, n, w_bytes=4)
            rec["shapes"].append(dict(shape=[m, k, n], ms=ms,
                                      call_ms=per_call, plain_ms=plain,
                                      bound_ms=b, bound_by=by,
                                      matmul_bf16_ms=mm_ms,
                                      passes_ms=passes))
            line += (f"; {ms:.4f} ms on the device, {per_call:.4f} ms per "
                     f"call (plain {plain:.4f} ms, bound {b:.4f} ms by "
                     f"{by}, {b32:.4f} ms with f32 weights; torch.matmul "
                     f"on the bf16 operands {mm_ms:.4f} ms); one cold "
                     f"call's passes {passes}")
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


def conversions_per_token(cfg, slices: int = 1) -> int:
    """A/D conversions one token costs in one layer: slices x N x
    ceil(K/128) per projection (``slices`` = k_i k_w on the bit-exact
    datapath, 1 on the per-group one)."""
    return slices * sum(n * -(-k // 128) for k, n in projection_shapes(cfg))


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


def trace_prompts(cfg):
    """8 prompts: a shared 48-token prefix plus a 16-token tail each."""
    import numpy as np
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 16)])
            for _ in range(8)]


def warm(rt):
    """Warm the libraries (cuBLAS handles, the kernels' modules) off the
    record."""
    import numpy as np
    (_, cache), _ = rt.prefill(np.zeros((1, 16), np.int32), max_len=256)
    rt.decode(np.zeros((1, 1), np.int32), cache)


def run_trace(torch, rt, cfg, counter, kname: str) -> dict:
    """Serve the trace of :func:`trace_prompts` on ``rt`` (paged engine,
    max batch 4, 16 new tokens each, greedy), with ``counter.LAUNCHES`` set
    to 0 just before and read just after.  Fails unless every projection
    of every forward launched the kernel, every request got 16 in-vocab
    tokens and the prefix was reused."""
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(rt, max_batch=TRACE_BATCH, max_len=256,
                         block_size=16)
    prompts = trace_prompts(cfg)
    counter.LAUNCHES = 0
    calls0 = rt.forward_calls
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, max_new_tokens=16)
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.LAUNCHES
    calls = rt.forward_calls - calls0

    st = engine.stats()
    for r in sorted(done, key=lambda r: r.uid):
        log(f"  req {r.uid}: reused {r.reused_tokens} prompt tokens, "
            f"ttft {1e3 * (r.first_token_t - r.submit_t):.1f} ms, ad_ops "
            f"{r.ad_ops:.0f} (prefill {r.prefill_ad_ops:.0f}), tokens "
            f"{list(r.generated)}")
    log(f"  served {st['requests']} requests, {st['decode_tokens']} tokens "
        f"in {wall:.2f} s: {st['tokens_per_s']:.2f} tok/s, mean ttft "
        f"{1e3 * st['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{st['total_ad_ops']:.0f}, {calls} forwards, {kname} launches "
        f"{launches}")

    want_launches = PROJ_PER_LAYER * cfg.n_layers * calls
    if launches != want_launches or calls == 0:
        raise AssertionError(f"{kname} launched {launches} times for "
                             f"{calls} forwards; expected {want_launches}")
    if len(done) != 8 or any(len(r.generated) != 16 or not all(
            0 <= t < cfg.vocab_size for t in r.generated) for r in done):
        raise AssertionError("engine did not return 16 in-vocab tokens for "
                             "each of the 8 requests")
    if sorted(r.reused_tokens for r in done) != [0] + [48] * 7:
        raise AssertionError("prefix reuse did not serve the shared prefix")
    # prefills convert their suffix tokens, every decode step converts all
    # max_batch rows
    rows = (sum(64 - r.reused_tokens for r in done)
            + engine.max_batch * (calls - len(done)))
    return dict(tokens_per_s=st["tokens_per_s"],
                mean_ttft_ms=1e3 * st["mean_ttft_s"],
                total_ad_ops=st["total_ad_ops"], forwards=calls,
                launches=launches, wall_s=wall, rows=rows,
                tokens=[list(r.generated) for r in
                        sorted(done, key=lambda r: r.uid)])


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` between two synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    return sorted(times)[reps // 2]


def forward_times(torch, rt, prompt) -> dict:
    """One batch-4 decode step and one 64-token prefill, host clock."""
    import numpy as np
    dec_cache = rt.init_cache(TRACE_BATCH, 256)
    dec_toks = np.zeros((TRACE_BATCH, 1), np.int32)
    return dict(
        decode_step_ms=wall_ms(torch, lambda: rt.decode(dec_toks,
                                                         dec_cache)),
        prefill64_ms=wall_ms(torch, lambda: rt.prefill(prompt[None],
                                                        max_len=256)))


@contextlib.contextmanager
def labelled_spans(torch):
    """Wrap the port's projection, auto-range pre-fit and attention
    functions in ``torch.profiler.record_function`` spans, so a trace can
    attribute device time to them (the package itself carries no spans).
    A function the package does not have (the pre-fit after it was folded
    into K1) is left out."""
    from repro_torch.models import attention, layers
    from repro_torch.pim import plan
    targets = [(layers, "pim_linear", "projections"),
               (plan, "auto_range_fit_grouped", "pre-fit"),
               (attention, "full_attention", "attention"),
               (attention, "chunked_attention", "attention"),
               (attention, "decode_attention", "attention"),
               (attention, "_scatter_time", "attention")]
    saved = []

    def wrap(fn, label):
        def inner(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return inner
    for mod, name, label in targets:
        fn = getattr(mod, name, None)
        if fn is not None:
            saved.append((mod, name, fn))
            setattr(mod, name, wrap(fn, label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _device_us(e) -> float:
    """Device time of a CPU event and its children (the attribute's name
    changed across PyTorch versions)."""
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_forward(torch, fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` (warmed first): the host
    clock of the call, the device's busy time (the union of its kernel and
    memset intervals) and idle share, device time by span (``K1`` from its
    kernels' names; the labelled spans of :func:`labelled_spans`) and the
    ten kernels that took longest.  ``measured`` is False when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with labelled_spans(torch):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    labels = ("projections", "pre-fit", "attention")
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in labels             # the spans' device mirrors
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return dict(measured=False, wall_ms=wall_ms)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    by_name: dict = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    k1 = [v for k, v in by_name.items() if "trq_group_mvm" in k]
    out = dict(measured=True, wall_ms=wall_ms, device_busy_ms=busy / 1e3,
               device_idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
               k1_ms=sum(us for _, us in k1) / 1e3,
               k1_kernels=sum(n for n, _ in k1))
    for label in labels:
        out[f"{label}_ms"] = sum(
            _device_us(e) for e in events
            if e.device_type == DeviceType.CPU and e.name == label) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out["top_kernels"] = [dict(name=k[:90], count=n, ms=us / 1e3)
                          for k, (n, us) in top]
    return out


def profile_forwards(torch, rt, prompt) -> dict:
    """The profile of one batch-4 decode step and one 64-token prefill."""
    import numpy as np
    dec_cache = rt.init_cache(TRACE_BATCH, 256)
    dec_toks = np.zeros((TRACE_BATCH, 1), np.int32)
    out = {}
    for key, fn in (("decode_step", lambda: rt.decode(dec_toks, dec_cache)),
                    ("prefill64", lambda: rt.prefill(prompt[None],
                                                     max_len=256))):
        p = out[key] = profile_forward(torch, fn)
        if not p["measured"]:
            log(f"  profile of one {key}: device time not measured (the "
                f"profiler saw no CUDA activity); host {p['wall_ms']:.1f} "
                f"ms")
            continue
        log(f"  profile of one {key}: host {p['wall_ms']:.1f} ms, device "
            f"busy {p['device_busy_ms']:.2f} ms (idle share "
            f"{p['device_idle_share']:.3f}); K1 {p['k1_ms']:.2f} ms in "
            f"{p['k1_kernels']} kernels, projections "
            f"{p['projections_ms']:.2f} ms, pre-fit {p['pre-fit_ms']:.2f} "
            f"ms, attention {p['attention_ms']:.2f} ms")
        for t in p["top_kernels"]:
            log(f"    {t['ms']:9.3f} ms {t['count']:5d}x {t['name']}")
    return out


def rel_l2(x, y) -> float:
    return float((x - y).norm() / y.norm())


def compile_pallas(torch, cfg, device: str = "cuda"):
    """Seeded full-width weights on the card, compiled on the prepared
    ``pallas`` datapath and warmed; logs the memory it holds."""
    from repro_torch import runtime
    from repro_torch.models.registry import init
    t0 = time.perf_counter()
    state = init(cfg, seed=0, device=device)
    rt = runtime.compile(cfg, state, device=device)
    del state
    torch.cuda.synchronize()
    gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  compiled {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, {len(rt.plan)} layer "
        f"plans on {rt.backend!r} in {time.perf_counter() - t0:.1f} s; "
        f"{gib:.2f} GiB allocated")
    warm(rt)
    torch.cuda.synchronize()
    return rt, gib


def serve_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    import numpy as np

    t = cfg.trq
    assert (t.n_r1, t.n_r2, t.auto_range) == (6, 6, True)
    rt, gib = compile_pallas(torch, cfg, device)

    run = run_trace(torch, rt, cfg, k1, "K1")
    rec["launches"] = run["launches"]
    # closed form of the op total: with n_r1 == n_r2 every conversion costs
    # nu + n_r = 7 ops
    want = 7 * cfg.n_layers * conversions_per_token(cfg) * run["rows"]
    if run["total_ad_ops"] != want:
        raise AssertionError(f"A/D ops {run['total_ad_ops']} != closed "
                             f"form {want}")
    log(f"  A/D ops equal the closed form {want} ({run['rows']} token rows)")
    serve = {k: run[k] for k in ("tokens_per_s", "mean_ttft_ms",
                                 "total_ad_ops", "forwards", "wall_s")}
    serve["gib_after_compile"] = gib
    prompts = trace_prompts(cfg)

    # one forward of each kind, host clock around a synchronised call, then
    # the profiler's split of the same two forwards
    serve.update(forward_times(torch, rt, prompts[0]))
    log(f"  one decode step (batch {TRACE_BATCH}) "
        f"{serve['decode_step_ms']:.1f} ms, one 64-token prefill "
        f"{serve['prefill64_ms']:.1f} ms")
    serve["profile"] = profile_forwards(torch, rt, prompts[0])

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


# ---------------------------------------------------------------------------
# phase 5: K2 against its plain version
# ---------------------------------------------------------------------------

def k2_phase(torch, rec: dict, device: str = "cuda") -> None:
    from repro_torch.kernels.trq_quant.kernel import trq_quant_cuda
    from repro_torch.kernels.trq_quant.ref import trq_quant_ref

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    modes = [dict(signed=True), dict(signed=False),
             dict(signed=True, mode="uniform")]
    x = torch.randn(37, 1029, generator=gen, device=dev) * 30
    checked = 0
    for pk in PARAM_GRID:
        for mode in modes:
            for dtype in (torch.float32, torch.float16):
                for delta in (1.0, 0.7):
                    xi = x if mode["signed"] else x.abs() * torch.where(
                        x > 50, -1.0, 1.0)
                    xi = xi.to(dtype)
                    s = torch.tensor([delta, pk["bias"]], device=dev)
                    regs = dict(n_r1=pk["n_r1"], n_r2=pk["n_r2"], m=pk["m"],
                                **mode)
                    q, ops = trq_quant_cuda(xi, s, **regs)
                    q_r, ops_r = trq_quant_ref(xi, s, **regs)
                    torch.cuda.synchronize()
                    rec["max_abs_err"] = max(rec["max_abs_err"], float(
                        (q - q_r).abs().max()))
                    if not (torch.equal(q, q_r) and torch.equal(ops, ops_r)):
                        raise AssertionError(
                            f"K2 differs from its plain version: {pk} "
                            f"{mode} {dtype} delta {delta}: max err "
                            f"{float((q - q_r).abs().max())}, ops equal "
                            f"{torch.equal(ops, ops_r)}")
                    checked += 1
    log(f"  {checked} register/mode/dtype cases on {tuple(x.shape)}: q "
        f"bitwise equal, ops equal")

    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    p = dict(n_r1=3, n_r2=6, m=2, signed=False)
    s = torch.tensor([1.0, 0.0], device=dev)
    for n in (CALIB_SAMPLES, K2_BIG):
        # bit-line-like samples: integers in [0, 128], skewed to zero
        y = torch.randn(n, generator=gen, device=dev).abs().mul(6).round() \
            .clamp(max=128)
        q, ops = trq_quant_cuda(y, s, **p)
        q_r, ops_r = trq_quant_ref(y, s, **p)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_r) and torch.equal(ops, ops_r)):
            raise AssertionError(f"K2 differs from its plain version at {n}")
        kern = lambda: trq_quant_cuda(y, s, **p)  # noqa: E731
        ms = device_ms(torch, kern, 20, flush)
        per_call = call_ms(torch, kern, 20, flush)
        plain = device_ms(torch, lambda: trq_quant_ref(y, s, **p), 5, flush)
        b = 12 * n / HBM_BYTES_PER_S * 1e3
        rec["shapes"].append(dict(shape=[n], ms=ms, call_ms=per_call,
                                  plain_ms=plain, bound_ms=b,
                                  bound_by="bytes"))
        log(f"  {n} samples: q and ops equal; {ms:.4f} ms on the device, "
            f"{per_call:.4f} ms per call (plain {plain:.4f} ms, bound "
            f"{b:.4f} ms by bytes)")


# ---------------------------------------------------------------------------
# phase 6: K3 against its plain version and an f64 control
# ---------------------------------------------------------------------------

def k3_bound(m: int, k: int, n: int, k_i: int = 8, k_w: int = 8):
    """Least time for one call: the packed activation and weight masks
    read once and y written once at the HBM rate, or the k_i k_w M K N
    one-bit multiply-adds (2 operations each) at the int8 tensor-core
    rate, whichever is larger."""
    g = -(-k // 128)
    byts = 16 * g * (k_i * m + k_w * n) + 4 * m * n + 8
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * k_i * k_w * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f64_control(torch, a_mask, w_mask, p):
    """The accumulator of the same datapath with its shift-add in f64:
    bit-line sums from an f32 0/1 einsum (exact), the plain quantizer,
    then sum q 2^(b+c) over (b, c, g) in double."""
    from repro_torch.core.trq import TRQParams, trq_quant
    from repro_torch.kernels.xbar_mvm.ref import unpack_planes
    psum = torch.einsum("imgx,jgxn->ijgmn", unpack_planes(a_mask),
                        unpack_planes(w_mask).transpose(2, 3))
    if p is not None:
        psum = trq_quant(psum, TRQParams(
            delta_r1=p.delta_r1, bias=p.bias, n_r1=p.n_r1, n_r2=p.n_r2,
            m=p.m, nu=p.nu, mode=p.mode, signed=False))
    k_i, k_w = a_mask.shape[0], w_mask.shape[0]
    bi = 2.0 ** torch.arange(k_i, dtype=torch.float64, device=psum.device)
    bj = 2.0 ** torch.arange(k_w, dtype=torch.float64, device=psum.device)
    return torch.einsum("ijgmn,i,j->mn", psum.double(), bi, bj)


def k3_operands(torch, gen, m: int, k: int, n: int, dev):
    """Main-path operands: bf16-valued activations and weights, PTQ'd to
    8-bit ints as the bit_exact backend does, offset-encoded and packed."""
    from repro_torch.kernels.xbar_mvm import pack_planes, pack_weight_planes
    from repro_torch.pim.backend import ptq_int, ptq_scale
    a = torch.randn(m, k, generator=gen, device=dev).bfloat16().float()
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
         ).bfloat16().float()
    a_u = ptq_int(a, ptq_scale(a, 8), 8) + 128
    u = ptq_int(w, ptq_scale(w, 8), 8) + 128
    return pack_planes(a_u, 8), pack_weight_planes(u, 8)


def k3_phase(torch, rec: dict, device: str = "cuda") -> None:
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.xbar_mvm.kernel import xbar_mvm_cuda
    from repro_torch.kernels.xbar_mvm import pack_scalars
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    u = 2.0 ** -24
    for (m, k, n) in MAIN_SHAPES + [(3, 300, 130)]:
        a_mask, w_mask = k3_operands(torch, gen, m, k, n, dev)
        g = -(-k // 128)
        for name, regs, unit in K3_REGS:
            p = make_params(device=dev, **regs) if regs else None
            s = pack_scalars(p, dev)
            kw = dict(lossless=p is None, per_output=True)
            if p is not None:
                kw.update(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu,
                          mode=p.mode)
            acc, ops, per = xbar_mvm_cuda(a_mask, w_mask, s, **kw)
            acc_r, ops_r, per_r = xbar_mvm_ref(a_mask, w_mask, s, **kw)
            ctrl = f64_control(torch, a_mask, w_mask, p)
            torch.cuda.synchronize()
            if int(ops) != int(ops_r) or not torch.equal(per, per_r):
                raise AssertionError(f"K3 op counts differ at {m}x{k}x{n} "
                                     f"{name}: {int(ops)} vs {int(ops_r)}")
            exact = ctrl < 2.0 ** 24 * unit       # every partial sum exact
            same = acc == acc_r
            bar = SLICES * g * u * ctrl
            err = (acc.double() - ctrl).abs()
            err_r = (acc_r.double() - ctrl).abs()
            n_exact = int(exact.sum())
            n_same = int(same.sum())
            ok = (bool(same[exact].all()) and bool((err <= bar).all())
                  and bool((err_r <= bar).all())
                  and bool(torch.isfinite(acc).all()))
            worst = float((acc - acc_r).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], worst)
            line = (f"  {m:>3}x{k:>5}x{n:>5} {name:>10}: ops {int(ops)} "
                    f"equal (per output too); y bitwise equal to plain at "
                    f"{n_same}/{acc.numel()} ({n_exact} in the exact "
                    f"region), max |K3 - plain| {worst:.3e}, max |K3 - "
                    f"f64| {float(err.max()):.3e} (bar at the worst "
                    f"element {float(bar.flatten()[err.argmax()]):.3e})")
            if not ok:
                raise AssertionError("K3 outside its bar:" + line)
            if name == "default" and (m, k, n) in MAIN_SHAPES:
                kw_main = dict(kw, per_output=False)
                kern = lambda: xbar_mvm_cuda(  # noqa: E731
                    a_mask, w_mask, s, **kw_main)
                ms = device_ms(torch, kern, 20, flush)
                per_call = call_ms(torch, kern, 20, flush)
                plain = device_ms(torch, lambda: xbar_mvm_ref(
                    a_mask, w_mask, s, **kw_main), 3, flush)
                b, by = k3_bound(m, k, n)
                rec["shapes"].append(dict(shape=[m, k, n], ms=ms,
                                          call_ms=per_call, plain_ms=plain,
                                          bound_ms=b, bound_by=by))
                line += (f"; {ms:.4f} ms on the device, {per_call:.4f} ms "
                         f"per call (plain {plain:.4f} ms, bound {b:.4f} ms "
                         f"by {by})")
            log(line)
            del acc, acc_r, ctrl, err, err_r, per, per_r
        del a_mask, w_mask
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7 and 8: the bit-exact datapath at full width, then Algorithm 1
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route K2 and K3 to their plain versions on the card (the package
    dispatches by device and has no such switch)."""
    from repro_torch.kernels.trq_quant import ops as k2_ops
    from repro_torch.kernels.trq_quant.ref import trq_quant_ref
    from repro_torch.kernels.xbar_mvm import ops as k3_ops
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    saved = k2_ops.trq_quant_cuda, k3_ops.xbar_mvm_cuda
    k2_ops.trq_quant_cuda, k3_ops.xbar_mvm_cuda = trq_quant_ref, xbar_mvm_ref
    try:
        yield
    finally:
        k2_ops.trq_quant_cuda, k3_ops.xbar_mvm_cuda = saved


def bit_exact_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch import runtime
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.registry import init
    import numpy as np

    t0 = time.perf_counter()
    rt = runtime.compile(cfg, init(cfg, seed=0, device=device),
                         device=device)
    torch.cuda.synchronize()
    log(f"  compiled {cfg.name} on {rt.backend!r}: {len(rt.plan)} layer "
        f"plans (packed cell masks) in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    warm(rt)
    torch.cuda.synchronize()
    run = run_trace(torch, rt, cfg, k3, "K3")
    rec["launches"] = run["launches"]
    per_token = cfg.n_layers * conversions_per_token(cfg, SLICES)
    want = 7 * per_token * run["rows"]
    if run["total_ad_ops"] != want:
        raise AssertionError(f"bit_exact A/D ops {run['total_ad_ops']} != "
                             f"closed form {want}")
    log(f"  A/D ops equal the closed form {want} = 7 ops x {per_token} "
        f"conversions per token row x {run['rows']} rows")
    out = {k: run[k] for k in ("tokens_per_s", "mean_ttft_ms",
                               "total_ad_ops", "forwards", "launches",
                               "wall_s", "rows")}
    out["conversions_per_token"] = per_token
    prompts = trace_prompts(cfg)
    out.update(forward_times(torch, rt, prompts[0]))
    per_call = {tuple(x["shape"]): x["ms"] for x in rec["shapes"]}
    for key, m in (("decode_step_k3_ms", 4), ("prefill64_k3_ms", 64)):
        out[key] = cfg.n_layers * sum(per_call[(m, k, n)]
                                      for k, n in projection_shapes(cfg))
    log(f"  one decode step (batch {TRACE_BATCH}) "
        f"{out['decode_step_ms']:.1f} ms, one 64-token prefill "
        f"{out['prefill64_ms']:.1f} ms; K3's device part from phase 6: "
        f"{out['decode_step_k3_ms']:.1f} ms and "
        f"{out['prefill64_k3_ms']:.1f} ms")

    # -- the plain version of K3 on one full-width prefill ------------------
    toks = prompts[0][None].astype(np.int32)
    (l_k, _), rep_k = rt.prefill(toks, max_len=256)
    with plain_kernels():
        t1 = time.perf_counter()
        (l_p, _), rep_p = rt.prefill(toks, max_len=256)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    rel = rel_l2(l_k, l_p)
    same_top = bool((l_k.argmax(-1) == l_p.argmax(-1)).all())
    log(f"  64-token prefill, K3 vs its plain version ({plain_s:.1f} s): "
        f"logits relative L2 {rel:.3e} (bar {BIT_EXACT_REL_BAR:.0e}), "
        f"bitwise {torch.equal(l_k, l_p)}, same argmax {same_top}, ad_ops "
        f"{rep_k.total():.0f} vs {rep_p.total():.0f}")
    if tuple(l_k.shape) != (1, cfg.vocab_size) or not bool(
            torch.isfinite(l_k).all()):
        raise AssertionError("bit_exact logits not finite or misshapen")
    if rel > BIT_EXACT_REL_BAR or not same_top or \
            rep_k.total() != rep_p.total():
        raise AssertionError("K3 and its plain version disagree at full "
                             "width")
    out.update(plain_logit_rel_l2=rel, plain_same_argmax=same_top)
    return out


def calibrate_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch import runtime
    from repro_torch.core.calibrate import calibrate_layer, summarize, \
        to_quant_state
    from repro_torch.kernels.trq_quant import kernel as k2
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.registry import init
    from repro_torch.pim.backend import ptq_int, ptq_scale
    from repro_torch.pim.crossbar import collect_bl_samples
    from repro_torch.pim.plan import iter_linears
    import numpy as np

    cfg = cfg.replace(scan_layers=False)
    rt = runtime.compile(cfg, init(cfg, seed=0, device=device),
                         device=device)
    lins = iter_linears(rt.model)
    inputs = {}
    hooks = [lin.register_forward_hook(
        lambda mod, args, _out: inputs.__setitem__(mod.name, args[0]))
        for _, lin in lins]
    prefix = trace_prompts(cfg)[0][:48]
    try:
        rt.prefill(prefix[None].astype(np.int32), max_len=64)
    finally:
        for h in hooks:
            h.remove()
    if len(inputs) != PROJ_PER_LAYER * cfg.n_layers:
        raise AssertionError(f"hooks saw {len(inputs)} projections")

    def samples(lin):
        """The layer's raw bit-line sums on the 48-token prefix: its
        quantized activations against its programmed weights."""
        x2 = inputs[lin.name].reshape(-1, lin.w.shape[0]).float()
        wf = lin.w.to(inputs[lin.name].dtype).float()
        a_u = ptq_int(x2, ptq_scale(x2, 8), 8) + 128
        return collect_bl_samples(a_u, ptq_int(wf, ptq_scale(wf, 8), 8))

    # -- the main path: every projection calibrated through K2 -------------
    k2.LAUNCHES = 0
    t0 = time.perf_counter()
    cal = {}
    for _, lin in lins:
        cal[lin.name] = calibrate_layer(samples(lin), n_max=7)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    rec["launches"] = k2.LAUNCHES
    summ = summarize(cal)
    kinds = {}
    for c in cal.values():
        key = (c.chosen, c.dist.kind)
        kinds[key] = kinds.get(key, 0) + 1
    log(f"  calibrated {summ['layers']} layers in {cal_s:.1f} s through "
        f"{k2.LAUNCHES} K2 launches: {summ['twin_layers']} twin, mean "
        f"{summ['mean_ops']:.3f} ops per conversion (ratio to 8b "
        f"{summ['op_ratio_vs_8b']:.3f}); (chosen, distribution): "
        f"{sorted(kinds.items())}")
    if k2.LAUNCHES == 0 or summ["layers"] != len(lins):
        raise AssertionError("calibration did not run through K2")
    for d in CHECKED_DEPTHS:
        for name in [f"layer_{d}/attn/{w}" for w in ("wq", "wk", "wv",
                                                     "wo")] + \
                [f"layer_{d}/mlp/{w}" for w in ("w_gate", "w_up",
                                                "w_down")]:
            c = cal[name]
            p = c.params
            log(f"    {name}: {c.dist.kind}, {c.chosen} n_r1={p.n_r1} "
                f"n_r2={p.n_r2} m={p.m} nu={p.nu} delta_r1="
                f"{float(p.delta_r1):.6g} bias={float(p.bias):.0f}, "
                f"{c.mean_ops:.4f} ops/conversion, mse {c.mse:.4g}")

    # -- plain scoring picks the same registers ----------------------------
    checked = 0
    by_name = {lin.name: lin for _, lin in lins}
    with plain_kernels():
        for d in CHECKED_DEPTHS:
            for name in [n for n in by_name if n.startswith(f"layer_{d}/")]:
                want = calibrate_layer(samples(by_name[name]), n_max=7)
                got = cal[name]
                regs = [(c.chosen, c.params.mode, c.params.n_r1,
                         c.params.n_r2, c.params.m, c.params.nu,
                         float(c.params.delta_r1), float(c.params.bias))
                        for c in (got, want)]
                if regs[0] != regs[1]:
                    raise AssertionError(f"{name}: K2 scoring chose "
                                         f"{regs[0]}, plain scoring "
                                         f"{regs[1]}")
                checked += 1
    log(f"  plain scoring picked identical registers on {checked} layers "
        f"({', '.join(sorted({n.split('/')[-1] for n in by_name}))} at "
        f"depths {CHECKED_DEPTHS})")
    del inputs
    torch.cuda.empty_cache()

    # -- serve the trace with the calibrated registers ---------------------
    qs = to_quant_state(cal)
    rt_cal = rt.with_overrides(quant_state=qs)
    del rt
    warm(rt_cal)
    torch.cuda.synchronize()
    run = run_trace(torch, rt_cal, cfg, k3, "K3")
    conversions = cfg.n_layers * conversions_per_token(cfg, SLICES) * \
        run["rows"]
    uniform8 = 8 * conversions
    ratio = uniform8 / run["total_ad_ops"]
    log(f"  calibrated serving: {run['total_ad_ops']:.0f} A/D ops for "
        f"{conversions} conversions ({run['total_ad_ops'] / conversions:.4f}"
        f" per conversion) against {uniform8} for a uniform 8-bit SAR ADC: "
        f"ADC-op ratio {ratio:.4f}x (the paper reports 1.6-2.3x)")
    return dict(layers=summ["layers"], twin_layers=summ["twin_layers"],
                mean_ops=summ["mean_ops"], calibrate_s=cal_s,
                k2_launches=rec["launches"], plain_checked=checked,
                tokens_per_s=run["tokens_per_s"],
                mean_ttft_ms=run["mean_ttft_ms"],
                total_ad_ops=run["total_ad_ops"], conversions=conversions,
                uniform8_ad_ops=uniform8, adc_op_ratio=ratio,
                forwards=run["forwards"], k3_launches=run["launches"])


def pallas_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH).replace(param_dtype="bfloat16",
                                   pim_backend="pallas", remat="none")
    assert cfg.n_layers == N_LAYERS and cfg.d_model == 3072
    return cfg


def main(argv) -> int:
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
    if argv == ["--profile"]:
        # the profile of phase 3 alone, on any checkout of the port
        log("profile: full-width llama3.2-3b on pallas")
        cfg = pallas_config()
        rt, gib = compile_pallas(torch, cfg)
        times = forward_times(torch, rt, trace_prompts(cfg)[0])
        log(f"  one decode step (batch {TRACE_BATCH}) "
            f"{times['decode_step_ms']:.1f} ms, one 64-token prefill "
            f"{times['prefill64_ms']:.1f} ms")
        prof = profile_forwards(torch, rt, trace_prompts(cfg)[0])
        log(json.dumps({"profile": prof, "gib_after_compile": gib, **times}))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}; the only one is "
              f"--profile", file=sys.stderr)
        return 2

    rec = dict(name="trq_group_mvm", route="cuda",
               source="src/repro_torch/kernels/csrc/trq_group_mvm.cu",
               replaces="src/repro/kernels/trq_group_mvm/kernel.py:57",
               launches=0, max_abs_err=0.0, flips=0, elements=0, shapes=[])
    rec2 = dict(name="trq_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/trq_quant.cu",
                replaces="src/repro/kernels/trq_quant/kernel.py:40",
                launches=0, max_abs_err=0.0, shapes=[])
    rec3 = dict(name="xbar_mvm", route="cuda",
                source="src/repro_torch/kernels/csrc/xbar_mvm.cu",
                replaces="src/repro/kernels/xbar_mvm/kernel.py:72",
                launches=0, max_abs_err=0.0, shapes=[])
    log("phase 2: trq_group_mvm against its plain version")
    k1_phase(torch, rec)
    log("phase 3: serve full-width llama3.2-3b on pallas")
    cfg = pallas_config()
    serve = serve_phase(torch, rec, cfg)
    torch.cuda.empty_cache()
    log("phase 5: trq_quant against its plain version")
    k2_phase(torch, rec2)
    log("phase 6: xbar_mvm against its plain version and an f64 control")
    k3_phase(torch, rec3)
    log("phase 7: serve full-width llama3.2-3b on bit_exact")
    cfg_be = cfg.replace(pim_backend="bit_exact")
    serve_be = bit_exact_phase(torch, rec3, cfg_be)
    torch.cuda.empty_cache()
    log("phase 8: Algorithm 1 on the card, then serve the calibrated "
        "registers")
    calib = calibrate_phase(torch, rec2, cfg_be)

    for r, shape in ((rec, HEADLINE_SHAPE), (rec2, [CALIB_SAMPLES]),
                     (rec3, HEADLINE_SHAPE)):
        head = next(x for x in r["shapes"] if tuple(x["shape"]) ==
                    tuple(shape))
        r.update(shape=head["shape"], ms=head["ms"],
                 plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                 bound_by=head["bound_by"], library_ms=None)
    log(json.dumps({"serve": serve}))
    log(json.dumps({"serve_bit_exact": serve_be}))
    log(json.dumps({"calibration": calib}))
    log(card_line())
    log(json.dumps({"kernels": [rec, rec2, rec3]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

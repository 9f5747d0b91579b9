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
           float bar (rtol=atol=1e-5 on at least 99.9 % of elements, read
           on at least 65,536 outputs: a case of fewer is drawn again
           until it has that many; any
           other element within one coarse quantizer step per 128-row
           group: a boundary flip from another f32 summation order), and
           on the ``w_gate`` of one 2,048-token prefill; rwkv6-7b's four
           projection shapes (4,096 -> 4,096 / 14,336 / 65,536 and 14,336
           -> 4,096) at M = 1, 2, 4, 8, 16, 32 and 64, whisper-medium's
           three (1,024 -> 1,024 / 4,096 and 4,096 -> 1,024) at M = 4, 8
           and 1,500, granite-moe-3b-a800m's two (1,536 -> 1,536 / 512)
           at M = 1, 2, 3, 4, 16 and 64, and jamba-v0.1-52b's four new
           ones (4,096 -> 16,384 / 1,024, 8,192 -> 288 / 4,096; ``x_proj``'s
           288 ends K1's 128-column blocks on a ragged 32) at M = 1, 2, 3,
           4, 16 and 64, exact and at the
           float bar with equal ops; times of the whole call (both passes)
           at M = 4, 16, 64 and that prefill (on rwkv6's shapes, at those
           phase 11's trace gives the kernel, ``RWKV_PATH``; on whisper's,
           at phase 12's, ``WHISPER_PATH``; on granite's, at phase 13's,
           ``GRANITE_PATH``; on jamba's, at phase 14's, ``JAMBA_PATH``)
           beside the
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
           or 1e-2 if that is larger; the relative L2 of the residual
           stream after four depths, held to the same bar against its own
           control at every depth where that control reads at most 0.1
           (layer 0 among them, or the check fails);
5. K2      ``trq_quant`` against its plain version on the card, registers of
           ``tests/test_kernels.py::PARAM_GRID`` in signed, unsigned and
           uniform modes, f32 and f16 input: q bitwise equal (atol=0) and
           ops equal; timed at the calibration shape (65,536 samples) and
           at 2^26 elements, beside the bound by bytes (4 B read, 8 B
           written per element).  Then its scoring entry ``trq_score``
           against ``trq_score_ref`` on three tables at 65,536 samples: the
           PARAM_GRID registers (signed, unsigned, uniform; steps 1.0 and
           0.7) on random floats, and the tables ``calibrate_layer`` builds
           for integer samples of a ``normal`` (154 candidates) and an
           ``other`` layer (450): op sums equal, squared-error sums equal
           once rounded to f32 (what the search reads) and, on every
           integral step over integer samples, bitwise in f64; timed on the
           normal table beside its bound (C x n evaluations at the fewest
           instructions one takes, read from the SASS of this build, over
           the card's instruction rate), its plain version, and the
           elementwise route written out in the phase (one elementwise
           launch per candidate and the torch ops around it, f32 sums);
6. K3      ``xbar_mvm`` against its plain version at the four projection
           shapes for M = 1, 4, 16, 17 and 64 (decode, continued prefill,
           prefill and the ragged tiles), rwkv6-7b's four projection shapes
           at M = 1, 2, 4, 8, 16, 32 and 64, whisper-medium's three at M =
           4, 8 and 1,500, granite-moe-3b-a800m's two at M = 1, 2, 3, 4, 16
           and 64, jamba-v0.1-52b's four new ones at M = 1, 2, 3, 4, 16
           and 64, ragged 3 x 300 x 130, and one
           shape with k_i = k_w = 4 (the general body), with the default
           registers, a fractional step and the lossless mode: op counts
           (total and per output) exactly equal everywhere; y bitwise equal
           wherever the f64 control's shift-add stays below 2^24 units of
           the quantizer's grid, and elsewhere, for kernel and plain
           version alike, within the recursive-summation bound
           k_i k_w G u |y| (u = 2^-24) of the f64 control; each kernel
           body's shapes (the wrapper's shape plan) are printed; timed at
           M = 4, 16 and 64 (on rwkv6's shapes, at phase 11's; on
           whisper's, at phase 12's; on granite's, at phase 13's; on
           jamba's, at phase 14's) beside the
           bound (packed bytes at 3.35 TB/s or
           the 0/1 products at the card's one-bit tensor-core rate,
           ``B1_OPS_PER_S``) and ``torch._int_mm`` on the unpacked int8 0/1
           planes, (k_i M, K) @ (K, k_w N), as a yardstick (the same
           multiply-adds with no per-group conversion; never on the path);
           then at every (K, N) of LeNet-5 and ResNet-20 (N as small as 6,
           K = 25 and 27 in one part-filled group) at M = 1, 4 and one
           256-image eval batch's M (up to 262,144), lossless, on twin
           and on ``mode="uniform"`` registers: out, per-output ops and
           the total bit for bit; timed at the eval M beside the byte and
           one-bit bounds and ``torch._int_mm``;
7. bit_exact  full-width llama3.2-3b on the prepared ``bit_exact``
           datapath, the phase-3 trace: every projection of every forward
           launched K3, and the A/D ops equal the closed form (k_i k_w
           ceil(K/128) N conversions per token row of a projection, 7 ops
           each); the ``torch.profiler`` reading of one batch-4 decode step
           and one 64-token prefill (K3's device time, the rest of the
           projections, attention, device-idle share); then one 64-token
           prefill on the plain version of K3: relative L2 of the logits
           within 1e-2, the same argmax, equal A/D ops;
8. calibrate  Algorithm 1 on the card: one prefill of the shared prefix
           on a ``bit_exact`` Runtime with per-depth names
           (``scan_layers=False``); forward hooks take each of the 196
           projections' inputs, ``collect_bl_samples`` turns them into the
           layer's bit-line sums, which are subsampled once and kept;
           ``calibrate_layer(n_max=7)`` scores all of a layer's candidates
           in one launch of K2's scoring entry (196 launches, no
           elementwise one), timed with the collection's share; scoring
           with the plain version must pick identical registers on all
           196 layers; the elementwise route (f32 sums, one elementwise launch
           a candidate) on the same samples may pick otherwise only on an
           exact tie (both candidates' exact sums printed); the calibrated
           QuantState then serves the trace and its A/D ops are read
           against the uniform 8-bit baseline;
9. bench   ``benchmarks/serve_bench_torch.py``'s shared-prefix chat (4
           requests sharing a 40-token prefix, 4 new tokens each, max
           batch 2) on full-width llama3.2-3b on ``pallas`` and on
           ``bit_exact``, prefix reuse on and off: tokens/s, mean TTFT,
           A/D ops per request, the saving from reuse and whether greedy
           tokens agree with and without reuse (a reading: dynamic scales
           make them differ, in the reference too); fails unless reuse
           serves the prefix and strictly saves A/D ops and the per-layer
           census (``pim.ad_ops_tally``) of one prefill sums to the
           engine's total bit for bit; then ``Runtime.save`` of phase 8's
           calibrated QuantState must load back equal; then the full
           ``mixed_archs`` scenario on ``pallas`` (llama3.2-3b, rwkv6-7b
           and whisper-medium with 8 zero frames a prompt, at full width),
           which must serve all three archs with nothing pending;
10. noise  the ``noisy`` backend: with no CrossbarModel and with the
           all-zeros one, a full-width prefill and one ``w_gate`` call give
           y and A/D ops bitwise equal to ``bit_exact``, through K3; a
           seeded model with every fault kind reproduces itself bit for bit
           at the smoke config (two compiled plans and the dynamic path)
           and on one full-width ``w_gate`` (the dynamic call and a baked
           plan, 8 ops a conversion); the fault rates and sigmas it draws
           there lie within 6 standard errors of the model's parameters.
           (A non-null plan holds f32 analog planes, 32 bytes a weight:
           a full-width model would not fit the card.)
11. rwkv6  full-width rwkv6-7b (32 layers, d=4,096, 64 heads of 64,
           d_ff=14,336, vocab 65,536, an untied ``lm_head``; bf16, seeded
           random weights) on the prepared ``pallas`` datapath, then on
           ``bit_exact``, through ``benchmarks/serve_bench_torch.py``'s
           mixed-archs trace (prompts of 12, 24 and 7 tokens, 6 new tokens
           each, max_len 64, max batch 2, greedy): every forward launches
           K1 (then K3) 257 times (32 x 8 projections and the
           ``lm_head``); every request's A/D ops equal the closed form (a
           token row that reaches every projection converts 67,108,864
           times, a prefill row that stops before the ``lm_head``
           65,011,712 times, 7 ops each, 64 bit-line conversions each on
           ``bit_exact``); tokens/s and mean TTFT; a ``torch.profiler``
           reading of one batch-2 decode step on each datapath (K1/K3, the
           WKV and the norms, device idle share); finite logits, and a
           full-width prefill on ``fake_quant`` against ``pallas`` at the
           phase-4 bar (its per-depth gate reaches layer 0 only: the
           recurrence amplifies quantizer-step flips, so the control grows
           past 0.1 by layer 8); the same prefill on ``bit_exact`` through K3's plain
           version at the phase-7 bar; and the chunked WKV scan of a
           prefill against the
           per-token recurrence (the state it carries and its outputs), at
           the model's head shapes and through layer 0's time-mix.
12. whisper full-width whisper-medium (24 encoder and 24 decoder layers,
           d=1,024, 16 heads of 64, d_ff=4,096, vocab 51,865, tied
           embeddings, every projection biased; bf16, seeded random
           weights, frames drawn once from a seeded ``torch.Generator``)
           on the prepared ``pallas`` datapath, then on ``bit_exact``,
           through the paged engine: a 30-second window of 1,500 frames
           per request, 4 requests of the 4-token decoder prompt
           (start-of-transcript, language, task, no-timestamps), 32 new
           tokens each, greedy, max batch 4, max_len 1,504.  Every prefill
           launches K1 (then K3) 385 times (the frame projection, 24 x 6
           encoder projections, 24 x 2 cross-KV, 24 x 8 decoder
           projections), every decode step 192; every request's A/D ops
           equal the closed form (per row on ``pallas``: 2,367,488
           conversions of a frame through the frame projection and the
           encoder and 393,216 for its cross-KV, 2,752,512 of a decoder
           row; 7 ops each, 64 bit-line conversions each on
           ``bit_exact``); every logit finite; each request holds a page
           for every 16 of its 1,500 cross-KV rows.  Readings: tokens/s,
           mean TTFT, the memory allocated after compile, and a
           ``torch.profiler`` reading of one batch-4 decode step of the
           engine (the paged ``assemble`` of self- and cross-KV, the
           forward, the write-back) and one 1,500-frame prefill on each
           datapath (K1/K3, attention, cross-attention, the encoder,
           device-idle share).  A full-width prefill on ``fake_quant``
           against ``pallas`` at the phase-4 bar (the per-depth gate on
           the decoder stream), and on ``bit_exact`` through K3's plain
           version at the phase-7 bar.
13. granite full-width granite-moe-3b-a800m (32 layers, d=1,536, 24
           query and 8 KV heads of 64, 40 experts of d_ff 512, top-8,
           vocab 49,155, tied embeddings; bf16, seeded random weights) on
           the prepared ``pallas`` datapath, then on ``bit_exact``, through
           the paged engine on phase 3's trace, with prefix reuse on and
           then off.  Only the attention projections are planned (the
           expert FFNs and the router are plain torch, as the reference's
           are plain ``jnp``): every forward (prefill, continued prefill,
           decode step) launches K1 (then K3) 128 times; every request's
           A/D ops equal the closed form derived from ``iter_linears``
           (11,010,048 ops a token row on ``pallas``, 7 a conversion, 64
           bit-line conversions each on ``bit_exact``) over its unreused
           prefill rows and its share of each decode step's 4 rows; reuse
           serves the 48-token prefix to the 7 later requests exactly when
           on; every logit finite.  Readings: tokens/s and mean TTFT in
           both modes, the memory allocated after compile, one batch-4
           decode step and one 64-token prefill (host clock) and their
           ``torch.profiler`` split (K1/K3, the rest of the projections,
           attention, the ``moe`` span: router, dispatch, experts and
           combine; device-idle share).  Checks: a full-width prefill on
           ``fake_quant`` against ``pallas`` at the phase-4 bar (the
           per-depth gate), the same prefill on ``bit_exact`` through K3's
           plain version at the phase-7 bar, and layer 0's MoE on the card
           in bf16 against the same layer in f64 (decode and 64-token
           prefill batches): the same experts for every token whose k-th
           and (k+1)-th probabilities differ by more than 1e-6, output
           within 2e-2 relative L2.
14. jamba  jamba-v0.1-52b at every published width (d=4,096, 32 query
           and 8 KV heads of 128, d_inner 8,192, d_state 16, d_conv 4,
           dt_rank 256, 16 experts of d_ff 14,336, top-2, vocab 65,536,
           an untied ``lm_head``; bf16, seeded random weights), cut to 16
           of its 32 layers (two of the four 8-layer periods: 14 mamba and
           2 attention layers, 8 MLP and 8 MoE; 26.05 B parameters, the
           whole model would not fit one card), on the prepared ``pallas``
           datapath, then on ``bit_exact``, through the paged engine on
           phase 3's trace asked for prefix reuse, which a hybrid keeps
           off (0 tokens reused).  Every forward (prefill, decode step)
           launches K1 (then K3) 75 times (14 x 3 mamba, 2 x 4 attention,
           8 x 3 MLP projections and the ``lm_head``; the experts and the
           router are plain torch); every request's A/D ops equal the
           closed form (25,030,656 conversions a token row, 22,933,504 a
           prefill row that stops before the ``lm_head``, over the 64-row
           bucket and the request's share of each decode step's 4 rows; 7
           ops each, 64 bit-line conversions each on ``bit_exact``); only
           the attention layers hold pages, the mamba state stays in the
           slots; every logit finite.  Checks: the chunked selective scan
           against the per-token step at the model's widths over 1,024
           tokens (four chunks carrying h) and layer 0's mixer on
           ``exact`` (a 64-token prefill against 64 single-token steps:
           outputs, ``h`` and ``conv``) within 1e-4 relative L2; layer 1's
           MoE against f64 (phase 13's bars); a full-width prefill on
           ``fake_quant`` against ``pallas`` at the phase-4 bar (how deep
           the per-depth gate reaches is printed), and on ``bit_exact``
           through K3's plain version at the phase-7 bar.  Readings:
           tokens/s and mean TTFT, the memory after compile and the
           phase's peak, one batch-4 decode step and one 64-token prefill
           (host clock) and their ``torch.profiler`` split (K1/K3, the
           rest of the projections, attention, the ``ssm`` span: conv,
           coefficients and scan; the ``moe`` span; device-idle share).
15. cnn    the paper's evaluation (``benchmarks/*_torch.py``,
           ``examples/quickstart_torch.py``): LeNet-5 (400 steps) and
           ResNet-20 (600 steps) trained from the port's seeded init with
           TF32 off (each one's loss at init and trained is printed);
           Fig. 3 on LeNet-5; Fig. 6 on both at 8..2 bits (512 images
           each); Figs. 6c
           and 7 on both (64 images); quickstart's steps 4 (K2's
           elementwise entry, bit for bit against ``core.trq.trq_quant``)
           and 5 (the backend sweep: K1 through ``pallas``, K3 through
           ``bit_exact``).  Every conv and FC runs K3, every calibration
           one K2 scoring launch.  Fails unless: the launches are the
           path's (one scoring launch a calibration, one elementwise, one
           K1, one K3 a conv or FC layer of each ``pim_forward`` batch and
           two for the sweep's ``bit_exact`` and ``noisy``); the lossless op total over the images equals the
           closed form of the real shapes (4,340,736 a LeNet-5 image,
           239,080,448 a ResNet-20 image); plain scoring picks the same
           registers on every layer at n_max = 4; K3 on one eval batch of
           every layer, lossless and calibrated, equals its plain version
           (out and ops; each layer's largest |acc| and its share at or
           above 2^24 printed).  Readings: every ``emit`` line, the
           accuracies, the op ratio against the paper's 1.6-2.3x, the
           Fig. 7 shares, K3's device ms per CNN layer against its bounds
           (phase 6), the phase's seconds by stage and its peak memory.

Kernel launch counts are reset just before each main path (phases 3, 11,
12, 13 and 14 for K1, phases 7, 11, 12, 13 and 14 for K3, the calibration
of phase 8 for both of K2's entries, phase 15 for all three) and read just
after; launches that compare a kernel with its plain version do not count.
The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

builds the kernels and runs only the profile of phase 3, on any checkout
of the port (the parent commit's too, for a before-and-after in one call).
"""
from __future__ import annotations

import contextlib
import gc
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
RWKV_ARCH = "rwkv6-7b"
RWKV_LAYERS = 32
RWKV_PROJ_PER_LAYER = 8            # w_r w_k w_v w_g w_o w_gate w_up w_down
# (K, N) of w_r/w_k/w_v/w_g/w_o, w_gate/w_up, w_down and the lm_head
RWKV_KN = ((4096, 4096), (4096, 14336), (14336, 4096), (4096, 65536))
# phases 2 and 6: rows checked at rwkv6's shapes (every M of phase 11's
# trace, 1, 2, 8, 16 and 32, and llama's 4 and 64)
RWKV_MS = (1, 2, 4, 8, 16, 32, 64)
# the shapes phase 11's trace gives K1 and K3, where both are timed: the
# batch-2 decode step (every projection and the lm_head), prefills in the
# buckets of 8, 16 and 32 rows, and the prefill's lm_head on its last row
RWKV_PATH = sorted({(2, k, n) for k, n in RWKV_KN}
                   | {(m, k, n) for m in (8, 16, 32) for k, n in RWKV_KN[:3]}
                   | {(1,) + RWKV_KN[3]})
RWKV_ROW = 67_108_864              # conversions of a row through all 257
RWKV_PREFILL_ROW = 65_011_712      # ... of a prefill row (no lm_head)
MIXED_NEW = 6                      # the mixed-archs trace's new tokens
MIXED_BATCH = 2
WHISPER_ARCH = "whisper-medium"
WHISPER_LAYERS = 24                # encoder layers, and decoder layers
# (K, N) of every attention projection and the frame projection, w_up,
# and w_down
WHISPER_KN = ((1024, 1024), (1024, 4096), (4096, 1024))
# phase 12's trace: a 30-second window of 1,500 encoder frames, 4 requests
# of a 4-token decoder prompt (start-of-transcript, language, task,
# no-timestamps: 50258, 50259, 50359, 50363), 32 new tokens each, greedy,
# max batch 4, max_len 1,504 (the least multiple of 16 rows that holds the
# frames)
WHISPER_FRAMES = 1500
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_NEW = 32
WHISPER_BATCH = 4
WHISPER_MAX_LEN = 1504
# the rows phase 12 gives K1 and K3 at whisper's shapes, where both are
# timed: the batch-4 decode step, the prompt's bucket of 8 decoder rows
# and the 1,500 frame rows (frame projection, encoder, cross-KV)
WHISPER_MS = (4, 8, WHISPER_FRAMES)
WHISPER_PATH = sorted((m, k, n) for m in WHISPER_MS for k, n in WHISPER_KN)
# K1 (K3) launches of one forward: the frame projection, 24 x 6 encoder
# projections, 24 x 2 cross-KV and 24 x 8 decoder projections at prefill;
# the decoder's alone at decode
WHISPER_PREFILL_LAUNCHES = 385
WHISPER_DECODE_LAUNCHES = 192
# conversions per row on pallas: a frame row through the frame projection
# and the encoder, the same row's cross-KV, a decoder row
WHISPER_FRAME_ROW = 2_367_488
WHISPER_XKV_ROW = 393_216
WHISPER_DEC_ROW = 2_752_512
GRANITE_ARCH = "granite-moe-3b-a800m"
GRANITE_LAYERS = 32
# (K, N) of wq/wo and of wk/wv: the only planned projections (the expert
# FFNs and the router bypass pim_linear, as in the reference)
GRANITE_KN = ((1536, 1536), (1536, 512))
GRANITE_LAUNCHES = 128             # 32 x 4 attention projections a forward
# phases 2 and 6: rows checked at granite's shapes: 1-4 (decode), 16 (a
# continued prefill's suffix under reuse), 64 (the trace's bucket)
GRANITE_MS = (1, 2, 3, 4, 16, 64)
# the rows phase 13's trace gives K1 and K3, where both are timed
GRANITE_PATH = sorted((m, k, n) for m in (4, 16, 64) for k, n in GRANITE_KN)
GRANITE_ROW = 11_010_048           # pallas A/D ops of a token row (7 each)
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 16                  # two of the four 8-layer periods
# (K, N) of in_proj, x_proj, out_proj and wk/wv: the shapes jamba adds
# (wq/wo 4,096 -> 4,096, the MLP's and the lm_head's are rwkv6's)
JAMBA_KN = ((4096, 16384), (8192, 288), (8192, 4096), (4096, 1024))
# phases 2 and 6: rows checked at jamba's new shapes (1-4: decode, 16: the
# TMA body's last M, 64: the trace's bucket)
JAMBA_MS = (1, 2, 3, 4, 16, 64)
# the shapes phase 14's trace gives K1 and K3, where both are timed: every
# projection at the batch-4 decode step and the 64-token prefill, the
# lm_head on the decode step and on the prefill's last row
JAMBA_PATH = sorted({(m, k, n) for m in (4, 64) for k, n in
                     JAMBA_KN + ((4096, 4096), (4096, 14336), (14336, 4096))}
                    | {(1, 4096, 65536), (4, 4096, 65536)})
# K1 (K3) launches a forward: 14 x 3 mamba, 2 x 4 attention, 8 x 3 MLP
# projections and the lm_head (the experts and the router are plain torch)
JAMBA_LAUNCHES = 75
JAMBA_ROW = 25_030_656             # conversions of a row through all 75
JAMBA_PREFILL_ROW = 22_933_504     # ... of a prefill row (no lm_head)
JAMBA_SCAN_LEN = 1024              # phase 14: four 256-token chunks
ROUTER_MARGIN = 1e-6               # phase 13: k-th less (k+1)-th probability
ROUTER_REL_BAR = 2e-2              # phase 13: bf16 MoE layer against f64
WKV_TOL = 1e-4                     # phase 11: scan against recurrence
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
FLIP_SAMPLE = 2 ** 16              # phase 2: least outputs a case's flip
                                   # rate is read on
LOGIT_CTRL_FACTOR = 3.0           # phase 4: pallas within 3x the control
LOGIT_REL_FLOOR = 1e-2
DEPTH_CTRL_MAX = 0.1               # phases 4, 11: depths held to the bar
# one-bit AND-popcount tensor cores (K3's type): the data sheet gives no
# rate, so the highest that tools/k3_mma_rates.cu measured (mma.m16n8k256,
# an H100 80GB HBM3 at 700 W)
B1_OPS_PER_S = 9064.3e12
CALIB_SAMPLES = 65536              # core.calibrate.MAX_CALIB_SAMPLES
K2_BIG = 2 ** 26
SCORE_TABLES = ("param_grid", "normal", "other")   # phase 5's scoring
# thread-instructions a second: 132 SMs x 4 x 32 lanes at 1.98 GHz, the
# clock of the data sheet's f32 rate (an FFMA is two of its operations)
INSTRUCTIONS_PER_S = F32_FLOP_PER_S / 2
# K3 registers: (name, make_params kwargs or None for lossless, the grid
# unit every quantized bit-line sum is a multiple of)
K3_REGS = [("default", dict(delta_r1=1.0, n_r1=6, n_r2=6, m=4), 1.0),
           ("fractional", dict(delta_r1=0.75, n_r1=4, n_r2=5, m=3,
                               bias=1.0), 0.25),
           ("lossless", None, 1.0)]
TRACE_BATCH = 4                    # the engine's max batch in the trace
SLICES = 8 * 8                     # k_i x k_w bit-line conversions per group
K3_MS = (1, 4, 16, 17, 64)         # phase 6: rows checked (every row tile)
PLAIN_BYTES = 2 ** 31              # phase 6: the plain version in column
                                   # blocks of at most this much psum
K3_TIMED_MS = (4, 16, 64)          # decode, prefill_cont, prefill
K3_NARROW = (16, 3072, 1024, 4)    # M, K, N, k_i = k_w: the general body
BIT_EXACT_REL_BAR = 1e-2           # phase 7: plain vs K3 logits
CHECKED_DEPTHS = (0, N_LAYERS - 1)  # phase 8: registers printed
CNN_EVAL_BATCH = 256               # phases 6 and 15: images in an eval batch
# phase 6 at the CNNs' shapes: lossless, twin and uniform registers
CNN_K3_REGS = [("lossless", None),
               ("twin", dict(delta_r1=1.0, n_r1=4, n_r2=4, m=3)),
               ("uniform", dict(delta_r1=2.5, n_r1=4, n_r2=4, m=0,
                                mode="uniform"))]


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
    and f32 weights; timed at the main paths' shapes (llama's M = 4, 16,
    64, ``RWKV_PATH``) and
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
    cases += [((m, k, n), default) for m in RWKV_MS for k, n in RWKV_KN]
    cases += [((m, k, n), default) for m, k, n in WHISPER_PATH]
    cases += [((m, k, n), default) for m in GRANITE_MS
              for k, n in GRANITE_KN]
    cases += [((m, k, n), default) for m in JAMBA_MS for k, n in JAMBA_KN]
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
    log(f"  exact: {n_exact} integer cases (M in {K1_MS} at llama's four "
        f"projection shapes, M in {RWKV_MS} at rwkv6's four, M in "
        f"{WHISPER_MS} at whisper's three, M in {GRANITE_MS} at granite's "
        f"two, M in {JAMBA_MS} at jamba's four, 3x300x130 and "
        f"{TMA_RAGGED}; bf16 and f32 weights; registers "
        f"given and auto-ranged): y bitwise equal, ops equal")

    # -- float: bf16-valued operands, registers given and auto-ranged ------
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    cases = [((m, k, n), default, wdt, auto)
             for m in K1_MS for k, n in PROJ_KN for wdt in wdtypes
             for auto in (False, True)]
    cases += [((m, k, n), default, torch.bfloat16, auto)
              for m in RWKV_MS for k, n in RWKV_KN for auto in (False, True)]
    cases += [((m, k, n), default, torch.bfloat16, auto)
              for m, k, n in WHISPER_PATH for auto in (False, True)]
    cases += [((m, k, n), default, torch.bfloat16, auto)
              for m in GRANITE_MS for k, n in GRANITE_KN
              for auto in (False, True)]
    cases += [((m, k, n), default, torch.bfloat16, auto)
              for m in JAMBA_MS for k, n in JAMBA_KN
              for auto in (False, True)]
    cases += [((64, 3072, 1024), r, torch.bfloat16, True) for r in R1_REGS]
    cases += [(shape, default, wdt, True) for wdt in wdtypes
              for shape in ((3, 300, 130), TMA_RAGGED)]
    cases += [(LONG_PREFILL, default, torch.bfloat16, True)]
    for (m, k, n), rk, wdt, auto in cases:
        # the flip bar is a rate: a case of few outputs is drawn again
        # until it has FLIP_SAMPLE of them, each draw held to the rest
        draws = -(-FLIP_SAMPLE // (m * n))
        g = -(-k // 128)
        flips = elements = ops_k = ops_p = 0
        worst = step = 0.0
        ok = True
        for _ in range(draws):
            a = torch.randn(m, k, generator=gen, device=dev
                            ).bfloat16().float()
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
            err = (y - y_r).abs()
            close = err <= FLOAT_TOL + FLOAT_TOL * y_r.abs()
            flips_d = int((~close).sum())
            step_d = float(fitted.delta_r2 * grid)   # one coarse step
            worst_d = float(err.max())
            ok = ok and (
                worst_d <= g * step_d * (1 + FLOAT_TOL) + FLOAT_TOL
                and abs(int(ops) - int(ops_r))
                <= flips_d * g * abs(p.n_r2 - p.n_r1)
                and bool(torch.isfinite(y).all()))
            flips += flips_d
            elements += y.numel()
            ops_k, ops_p = ops_k + int(ops), ops_p + int(ops_r)
            if worst_d >= worst:
                worst, step = worst_d, step_d
        ok = ok and flips <= MAX_FLIP_FRACTION * elements
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
        rec["flips"] += flips
        rec["elements"] += elements
        wname = "bf16" if wdt == torch.bfloat16 else "f32"
        line = (f"  float  {m:>3}x{k:>5}x{n:>5} {wname} "
                f"{'auto ' if auto else 'given'} {rk}: flips {flips}/"
                f"{elements} in {draws} draw{'s' * (draws > 1)}, max err "
                f"{worst:.3e} (coarse step {step:.3e}), ops {ops_k} vs "
                f"{ops_p}")
        if not ok:
            raise AssertionError("K1 outside the float bar:" + line)
        if ((k, n) in PROJ_KN and m in K1_TIMED_MS or (m, k, n) in
                RWKV_PATH or (m, k, n) in WHISPER_PATH or (m, k, n) in
                GRANITE_PATH or (m, k, n) in JAMBA_PATH) and auto and \
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
    record; an encoder-decoder's prefill gets 8 zero frames."""
    import numpy as np
    extra = {"embeds": np.zeros((1, 8, rt.cfg.d_model), np.float32)} \
        if rt.cfg.encoder_layers else None
    (_, cache), _ = rt.prefill(np.zeros((1, 16), np.int32), extra,
                               max_len=256)
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


def forward_times(torch, rt, prompt, batch: int = TRACE_BATCH,
                  max_len: int = 256) -> dict:
    """One batch-``batch`` decode step and one prefill of ``prompt``, host
    clock."""
    import numpy as np
    dec_cache = rt.init_cache(batch, max_len)
    dec_toks = np.zeros((batch, 1), np.int32)
    return {"decode_step_ms": wall_ms(torch, lambda: rt.decode(
                dec_toks, dec_cache)),
            f"prefill{len(prompt)}_ms": wall_ms(torch, lambda: rt.prefill(
                prompt[None], max_len=max_len))}


@contextlib.contextmanager
def labelled_spans(torch):
    """Wrap the port's projection, auto-range pre-fit, attention, WKV,
    mamba (``ssm``: the conv, the coefficients after ``x_proj`` and the
    scan or step) and norm functions in ``torch.profiler.record_function``
    spans, so a trace
    can attribute device time to them (the package itself carries no
    spans).  A function the package does not have (the pre-fit after it
    was folded into K1) is left out."""
    from repro_torch.models import attention, encdec, layers, moe, rwkv6
    try:
        from repro_torch.models import mamba
    except ImportError:           # a checkout older than the mamba mixer
        mamba = None
    from repro_torch.pim import plan
    from repro_torch.serve import kvcache
    targets = [(layers, "pim_linear", "projections"),
               (plan, "auto_range_fit_grouped", "pre-fit"),
               (attention, "full_attention", "attention"),
               (attention, "chunked_attention", "attention"),
               (attention, "decode_attention", "attention"),
               (attention, "_scatter_time", "attention"),
               (encdec, "apply_cross_attention", "cross-attention"),
               (moe, "apply_moe", "moe"),
               (encdec.EncDec, "encode", "encoder"),
               (kvcache.PagedKVCache, "assemble", "assemble"),
               (kvcache.PagedKVCache, "write_blocks", "write-back"),
               (rwkv6, "wkv_scan", "wkv"),
               (rwkv6, "wkv_step", "wkv"),
               (mamba, "causal_conv", "ssm"),
               (mamba, "ssm_coeffs", "ssm"),
               (mamba, "ssm_scan", "ssm"),
               (mamba, "ssm_step", "ssm"),
               (rwkv6, "head_norm", "norm"),
               (layers, "rmsnorm", "norm"),
               (layers, "layernorm", "norm")]
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
    ten kernels that took longest.  ``K3`` is summed from its kernels'
    names the same way.  ``measured`` is False when the
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
    labels = ("projections", "pre-fit", "attention", "wkv", "norm",
              "cross-attention", "encoder", "assemble", "write-back", "moe",
              "ssm")
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
    k3 = [v for k, v in by_name.items() if "xbar_mvm" in k]
    out = dict(measured=True, wall_ms=wall_ms, device_busy_ms=busy / 1e3,
               device_idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
               k1_ms=sum(us for _, us in k1) / 1e3,
               k1_kernels=sum(n for n, _ in k1),
               k3_ms=sum(us for _, us in k3) / 1e3,
               k3_kernels=sum(n for n, _ in k3))
    for label in labels:
        out[f"{label}_ms"] = sum(
            _device_us(e) for e in events
            if e.device_type == DeviceType.CPU and e.name == label) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out["top_kernels"] = [dict(name=k[:90], count=n, ms=us / 1e3)
                          for k, (n, us) in top]
    return out


def profile_forwards(torch, rt, prompt, batch: int = TRACE_BATCH,
                     max_len: int = 256) -> dict:
    """The profile of one batch-``batch`` decode step and one prefill of
    ``prompt``."""
    import numpy as np
    dec_cache = rt.init_cache(batch, max_len)
    dec_toks = np.zeros((batch, 1), np.int32)
    return {key: profile_one(torch, key, fn) for key, fn in (
        ("decode_step", lambda: rt.decode(dec_toks, dec_cache)),
        (f"prefill{len(prompt)}", lambda: rt.prefill(prompt[None],
                                                     max_len=max_len)))}


def profile_one(torch, key: str, fn) -> dict:
    """:func:`profile_forward` of ``fn``, logged as ``key``."""
    p = profile_forward(torch, fn)
    if not p["measured"]:
        log(f"  profile of one {key}: device time not measured (the "
            f"profiler saw no CUDA activity); host {p['wall_ms']:.1f} ms")
        return p
    log(f"  profile of one {key}: host {p['wall_ms']:.1f} ms, device "
        f"busy {p['device_busy_ms']:.2f} ms (idle share "
        f"{p['device_idle_share']:.3f}); K1 {p['k1_ms']:.2f} ms in "
        f"{p['k1_kernels']} kernels, K3 {p['k3_ms']:.2f} ms in "
        f"{p['k3_kernels']} kernels, projections "
        f"{p['projections_ms']:.2f} ms, pre-fit {p['pre-fit_ms']:.2f} "
        f"ms, attention {p['attention_ms']:.2f} ms, wkv "
        f"{p['wkv_ms']:.2f} ms, norms {p['norm_ms']:.2f} ms"
        + "".join(f", {k} {p[k + '_ms']:.2f} ms" for k in (
            "cross-attention", "encoder", "assemble", "write-back", "moe",
            "ssm") if p[k + "_ms"]))
    for t in p["top_kernels"]:
        log(f"    {t['ms']:9.3f} ms {t['count']:5d}x {t['name']}")
    return p


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

    t = cfg.trq
    assert (t.n_r1, t.n_r2, t.auto_range) == (6, 6, True)
    rt, gib = compile_pallas(torch, cfg, device)

    run = run_trace(torch, rt, cfg, k1, "K1")
    rec["launches_by_path"][cfg.name] = run["launches"]
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

    log("phase 4: full-width prefill, fake_quant against pallas")
    serve.update(fake_quant_check(torch, rt, prompts[0], 256))
    return serve


def fake_quant_check(torch, rt, prompt, max_len: int,
                     extra=None) -> dict:
    """One full-width prefill of ``prompt`` on ``pallas`` (``rt``) against
    ``fake_quant``, the plain tensor version of the same math: finite
    logits of the vocabulary's width, equal A/D ops, and a relative L2
    within the bar.  Two exact implementations of one quantized network
    differ only where an f32 partial sum lands on the other side of a
    quantizer step, and many random bf16 layers amplify each such flip, so
    the bar is relative to a control: the plain version against itself
    with its partial sums accumulated in f64 (another rounding of the same
    math).  The residual stream after layer 0 and a few later depths is
    held to the same bar wherever its control reads at most
    ``DEPTH_CTRL_MAX`` (an encoder-decoder's decoder stream, which carries
    the encoder's flips through cross-attention).  ``extra`` goes to every
    prefill (an encoder-decoder's frames)."""
    toks = prompt[None].astype("int32")
    # the residual stream after a few depths, for each of the three runs
    # (pallas, fake_quant, control): where the divergence grows
    stack = rt.model.dec if rt.cfg.encoder_layers else rt.model.layers
    n = len(stack)
    seen: dict = {}
    hooks = [stack[d].register_forward_hook(
        lambda mod, args, out, d=d: seen.setdefault(d, []).append(
            out[0].float())) for d in sorted({0, n // 4, n // 2, n - 1})]
    try:
        (l_p, _), rep_p = rt.prefill(toks, extra, max_len=max_len)
        rt_fq = rt.with_overrides(backend="fake_quant")
        (l_f, _), rep_f = rt_fq.prefill(toks, extra, max_len=max_len)
        with f64_partial_sums(torch):
            (l_c, _), rep_c = rt_fq.prefill(toks, extra, max_len=max_len)
    finally:
        for h in hooks:
            h.remove()
    del rt_fq
    torch.cuda.synchronize()
    depth = {d: (rel_l2(x_p, x_f), rel_l2(x_c, x_f))
             for d, (x_p, x_f, x_c) in sorted(seen.items())}
    # held to the logits' bar at every depth whose control stays small
    # (a recurrence can amplify flips until the control accepts anything)
    gated = {d: max(LOGIT_CTRL_FACTOR * b, LOGIT_REL_FLOOR)
             for d, (a, b) in depth.items() if b <= DEPTH_CTRL_MAX}
    log("  residual stream after layer d, relative L2 to fake_quant "
        "(pallas; control; bar): " + "; ".join(
            f"{d}: {a:.3e}; {b:.3e}; "
            + (f"{gated[d]:.3e}" if d in gated else "none (a reading)")
            for d, (a, b) in depth.items()))
    if 0 not in gated or any(depth[d][0] > bar for d, bar in gated.items()):
        raise AssertionError("pallas and fake_quant disagree in the "
                             "residual stream")

    rel, ctrl = rel_l2(l_p, l_f), rel_l2(l_c, l_f)
    bar = max(LOGIT_CTRL_FACTOR * ctrl, LOGIT_REL_FLOOR)
    same_top = bool((l_p.argmax(-1) == l_f.argmax(-1)).all())
    finite = bool(torch.isfinite(l_p).all())
    log(f"  logits {tuple(l_p.shape)} (finite {finite}): pallas vs "
        f"fake_quant relative L2 "
        f"{rel:.3e} (bar {bar:.3e}); control (fake_quant with f64 partial "
        f"sums) {ctrl:.3e}; pallas vs control {rel_l2(l_p, l_c):.3e}; "
        f"same argmax {same_top}; ad_ops {rep_p.total():.0f} vs "
        f"{rep_f.total():.0f} vs {rep_c.total():.0f}")
    if tuple(l_p.shape) != (1, rt.cfg.vocab_size) or not finite:
        raise AssertionError("pallas logits not finite or misshapen")
    if rel > bar or not rep_p.total() == rep_f.total() == rep_c.total():
        raise AssertionError("pallas and fake_quant disagree at full width")
    return dict(logit_rel_l2=rel, control_rel_l2=ctrl, same_argmax=same_top,
                depth_rel_l2=depth, depth_bar=gated)


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


def score_samples(torch, kind: str, n: int, dev):
    """Samples and candidate registers of a phase-5 scoring table:
    ``param_grid``, the PARAM_GRID registers in signed, unsigned and
    uniform modes at steps 1.0 and 0.7 on random floats; ``normal`` and
    ``other``, the table ``calibrate_layer`` builds for integer bit-line-
    like samples of such a layer (integers about 32, as a random layer's
    bit-line sums; a flat spread over [0, 128])."""
    import numpy as np
    from repro_torch.core.calibrate import layer_candidates
    from repro_torch.core.distribution import classify
    from repro_torch.core.trq import make_params
    rng = np.random.default_rng(12)
    if kind == "param_grid":
        y = rng.normal(0, 30, n)
        cands = [make_params(delta_r1=d, **pk, **mode) for pk in PARAM_GRID
                 for mode in (dict(signed=True), dict(signed=False),
                              dict(signed=True, mode="uniform"))
                 for d in (1.0, 0.7)]
    else:
        y = rng.normal(32, 3, n).round() if kind == "normal" else \
            rng.integers(0, 129, n)
        dist = classify(y)
        if dist.kind != kind:
            raise AssertionError(f"{kind} samples classify as {dist.kind}")
        _, uniform, twin = layer_candidates(dist, n_max=7)
        cands = uniform + twin
    return torch.from_numpy(y.astype(np.float32)).to(dev), cands


def elementwise_scores(torch, y, cands):
    """A layer's scores by the elementwise route, written out as the
    yardstick (what ``core/calibrate.py::_scores`` did before the scoring
    entry):
    one elementwise K2 launch per candidate, then sub, square, an f32 sum,
    the int sum, the casts and a stack; one read of the (C, 2) means."""
    from repro_torch.kernels.trq_quant import trq_quant
    regs = torch.tensor([[float(p.delta_r1), float(p.bias)] for p in cands],
                        dtype=torch.float32).to(y.device)
    inv_n = 1.0 / y.numel()
    rows = []
    for i, p in enumerate(cands):
        q, ops = trq_quant(y, p.replace(delta_r1=regs[i, 0],
                                        bias=regs[i, 1]))
        rows.append(torch.stack([torch.sum(torch.square(q - y)) * inv_n,
                                 ops.sum().float() * inv_n]))
    return [(float(a), float(b)) for a, b in torch.stack(rows).cpu().numpy()]


def k2_score_phase(torch, rec: dict, device: str = "cuda") -> dict:
    """The scoring entry against its plain version on the three tables,
    then timed on the ``normal`` table (the calibration shape)."""
    from repro_torch.kernels.trq_quant import score_table
    from repro_torch.kernels.trq_quant.kernel import trq_score_cuda
    from repro_torch.kernels.trq_quant.ref import trq_score_ref

    dev = torch.device(device)
    for kind in SCORE_TABLES:
        y, cands = score_samples(torch, kind, CALIB_SAMPLES, dev)
        fregs, iregs = score_table(cands, dev)
        sq, ops = trq_score_cuda(y, fregs, iregs)
        sq_r, ops_r = trq_score_ref(y, fregs, iregs)
        torch.cuda.synchronize()
        f32_same = torch.eq(sq.float(), sq_r.float())
        f64_same = torch.eq(sq, sq_r)
        # integer samples on an integral step: every squared error is an
        # integer below 2^15, so the f64 sums are exact in any order
        exact = [i for i, p in enumerate(cands) if kind != "param_grid"
                 and float(p.delta_r1).is_integer()]
        rec["max_abs_err"] = max(rec["max_abs_err"], float(
            (sq.float() - sq_r.float()).abs().max()))
        log(f"  trq_score, {kind} table ({len(cands)} candidates, "
            f"{CALIB_SAMPLES} samples): ops sums equal "
            f"{torch.equal(ops, ops_r)}, squared-error sums equal in f32 "
            f"{int(f32_same.sum())}/{len(cands)}, in f64 "
            f"{int(f64_same.sum())}/{len(cands)} (integral steps "
            f"{int(f64_same[exact].sum())}/{len(exact)})")
        if not (torch.equal(ops, ops_r) and bool(f32_same.all())):
            for i in torch.nonzero(~f32_same | (ops != ops_r)).flatten():
                log(f"    candidate {int(i)} {cands[int(i)]}: kernel "
                    f"{float(sq[i])!r} / {int(ops[i])}, plain "
                    f"{float(sq_r[i])!r} / {int(ops_r[i])}")
            raise AssertionError(f"trq_score differs from its plain version "
                                 f"on the {kind} table")
        if not bool(f64_same[exact].all()):
            raise AssertionError("trq_score's f64 sums are not exact on "
                                 "integral steps")

    # timed at the calibration shape: a normal layer's table
    y, cands = score_samples(torch, "normal", CALIB_SAMPLES, dev)
    fregs, iregs = score_table(cands, dev)
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    kern = lambda: trq_score_cuda(y, fregs, iregs)  # noqa: E731
    ms = device_ms(torch, kern, 20, flush)
    per_call = call_ms(torch, kern, 20, flush)
    # the plain version reads the table to the host (its registers are
    # static Python values), so it cannot be captured: one call, as timed
    plain = call_ms(torch, lambda: trq_score_ref(y, fregs, iregs), 5, flush)
    # the elementwise route from the same registers, and the scoring route
    # as calibrate_layer calls it (table upload, launch, one read)
    elementwise = call_ms(torch, lambda: elementwise_scores(torch, y, cands),
                          5, flush)
    from repro_torch.core.calibrate import _scores
    route = call_ms(torch, lambda: _scores(y, cands), 20, flush)
    moved = sum(a != b for a, b in zip(elementwise_scores(torch, y, cands),
                                       _scores(y, cands)))
    log(f"  the elementwise route's f32 sums give other means than the "
        f"exact sums on {moved} of {len(cands)} candidates (a reading)")
    inst = score_instructions(y, cands)
    t_ops = inst["instructions"] / INSTRUCTIONS_PER_S * 1e3
    t_bytes = (4 * y.numel() + 32 * len(cands) + 16 * len(cands)) \
        / HBM_BYTES_PER_S * 1e3
    b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    out = dict(shape=[len(cands), y.numel()], ms=ms, call_ms=per_call,
               plain_ms=plain, bound_ms=b, bound_by=by,
               elementwise_route_ms=elementwise, calibrate_route_ms=route,
               instructions_per_evaluation=inst["per_evaluation"])
    log(f"  trq_score at {len(cands)} candidates x {y.numel()} samples: "
        f"{ms:.4f} ms on the device, {per_call:.4f} ms per call, "
        f"{route:.4f} ms as calibrate_layer scores (upload, launch, read); "
        f"bound {b:.4f} ms by {by} ({inst['instructions']:.4g} instructions: "
        f"{inst['per_evaluation']:.2f} an evaluation from the SASS, at "
        f"{INSTRUCTIONS_PER_S:.4g} a second); plain {plain:.4f} ms per call; "
        f"the elementwise route ({len(cands)} elementwise launches and the "
        f"torch ops around them) {elementwise:.4f} ms")
    log(f"  shortest paths of one evaluation in the SASS, per copy of the "
        f"unrolled loop: {inst['sass_paths']}")
    return out


SASS_INST = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def shortest_evaluations(sass: str, kernel: str) -> list:
    """Per unrolled copy of the scoring loop in ``kernel``'s SASS, the
    fewest instructions one evaluation takes: between two consecutive
    ``F2F.F64.F32`` (each evaluation widens its squared error once), the
    shortest path along fall-throughs and forward branches — the skip of
    the division's slow path taken, no loop back-edge.  Returns one list of
    path lengths per copy (a copy ends where no forward path joins two
    widenings: the signed and the unsigned copy of the loop)."""
    text = next(part for part in re.split(r"\n\s*Function : ", sass)[1:]
                if kernel in part.split("\n", 1)[0])
    insts = [(int(a, 16), bool(p), op, args)
             for a, p, op, args in SASS_INST.findall(text)]
    at = {a: i for i, (a, *_) in enumerate(insts)}
    widen = [i for i, x in enumerate(insts) if x[2].startswith("F2F.F64.F32")]
    copies, run = [], []
    for a, b in zip(widen, widen[1:]):
        dist = {a + 1: 1}
        for i in range(a + 1, b):
            if i not in dist:
                continue
            _, pred, op, args = insts[i]
            succ = [] if op in ("EXIT", "RET") else [i + 1]
            if op.startswith("BRA"):
                t = at.get(int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16))
                succ = ([i + 1] if pred else []) + \
                    ([t] if t is not None and t > i else [])
            for j in succ:
                if j <= b:
                    dist[j] = min(dist.get(j, 1 << 30), dist[i] + 1)
        if b in dist:
            run.append(dist[b])
        elif run:
            copies.append(run)
            run = []
    return copies + ([run] if run else [])


def score_instructions(y, cands) -> dict:
    """The scoring entry's work on this table, read from the SASS of this
    build: C x n evaluations at the least mean instructions an evaluation
    takes in any copy of the unrolled loop (a lower bound: it leaves out
    the candidate loop's reductions and a warp's divergent paths)."""
    from repro_torch.kernels import build
    copies = shortest_evaluations(build.sass("trq_quant"),
                                  "trq_score_partialsIf")
    if len(copies) < 2:
        raise AssertionError(f"expected a signed and an unsigned copy of "
                             f"the scoring loop in the SASS, found "
                             f"{copies}")
    per = min(sum(c) / len(c) for c in copies)
    return dict(per_evaluation=per, sass_paths=copies,
                instructions=per * len(cands) * y.numel())


# ---------------------------------------------------------------------------
# phase 6: K3 against its plain version and an f64 control
# ---------------------------------------------------------------------------

def k3_bound(m: int, k: int, n: int, k_i: int = 8, k_w: int = 8):
    """Least time for one call: the k_i activation and k_w weight bits of
    the K real rows read once (not the zero rows that fill the last
    128-row group) and y written once at the HBM rate, or the k_i k_w M K
    N one-bit multiply-adds (2 operations each) at the one-bit
    tensor-core rate, whichever is larger."""
    byts = (k_i * m + k_w * n) * k / 8 + 4 * m * n + 8
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * k_i * k_w * m * k * n / B1_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def column_blocks(a_mask, w_mask):
    """Column slices of ``w_mask`` whose (k_i, k_w, G, M, columns) f32
    bit-line sums stay within ``PLAIN_BYTES``: the plain version and the
    control run a block at a time (at M = 64 the lm_head's would take
    34 GB at once).  Columns are independent, so the blocks' results are
    the whole call's bit for bit."""
    k_i, m, g, _ = a_mask.shape
    n = w_mask.shape[2]
    cols = max(1, PLAIN_BYTES // (4 * k_i * w_mask.shape[0] * g * m))
    return [w_mask[:, :, c:c + cols] for c in range(0, n, cols)]


def plain_k3(torch, a_mask, w_mask, s, **kw):
    """K3's plain version, a column block at a time."""
    from repro_torch.kernels.xbar_mvm.ref import xbar_mvm_ref
    parts = [xbar_mvm_ref(a_mask, wb, s, **kw)
             for wb in column_blocks(a_mask, w_mask)]
    per = torch.cat([p[2] for p in parts], 1) if kw.get("per_output") \
        else None
    return (torch.cat([p[0] for p in parts], 1),
            torch.stack([p[1] for p in parts]).sum(), per)


def f64_control(torch, a_mask, w_mask, p):
    """The accumulator of the same datapath with its shift-add in f64:
    bit-line sums from an f32 0/1 einsum (exact), the plain quantizer,
    then sum q 2^(b+c) over (b, c, g) in double; a column block at a
    time."""
    from repro_torch.core.trq import TRQParams, trq_quant
    from repro_torch.kernels.xbar_mvm.ref import unpack_planes
    k_i, k_w = a_mask.shape[0], w_mask.shape[0]
    bi = 2.0 ** torch.arange(k_i, dtype=torch.float64, device=a_mask.device)
    bj = 2.0 ** torch.arange(k_w, dtype=torch.float64, device=a_mask.device)
    out = []
    for wb in column_blocks(a_mask, w_mask):
        psum = torch.einsum("imgx,jgxn->ijgmn", unpack_planes(a_mask),
                            unpack_planes(wb).transpose(2, 3))
        if p is not None:
            psum = trq_quant(psum, TRQParams(
                delta_r1=p.delta_r1, bias=p.bias, n_r1=p.n_r1, n_r2=p.n_r2,
                m=p.m, nu=p.nu, mode=p.mode, signed=False))
        out.append(torch.einsum("ijgmn,i,j->mn", psum.double(), bi, bj))
        del psum
    return torch.cat(out, 1)


def k3_operands(torch, gen, m: int, k: int, n: int, dev, bits: int = 8):
    """Main-path operands: bf16-valued activations and weights, PTQ'd to
    ``bits``-bit ints as the bit_exact backend does, offset-encoded and
    packed."""
    from repro_torch.kernels.xbar_mvm import pack_planes, pack_weight_planes
    from repro_torch.pim.backend import ptq_int, ptq_scale
    a = torch.randn(m, k, generator=gen, device=dev).bfloat16().float()
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
         ).bfloat16().float()
    half = 2 ** (bits - 1)
    a_u = ptq_int(a, ptq_scale(a, bits), bits) + half
    u = ptq_int(w, ptq_scale(w, bits), bits) + half
    return pack_planes(a_u, bits), pack_weight_planes(u, bits)


def int_mm_planes(torch, a_mask, w_mask):
    """The yardstick's operands: the unpacked int8 0/1 planes as one
    (k_i M, K) @ (K, k_w N) product for ``torch._int_mm``, whose rows are
    more than 16: fewer (M <= 2) are padded with zero rows to 24."""
    from repro_torch.kernels.xbar_mvm.ref import unpack_planes
    k_i, m = a_mask.shape[:2]
    k_w, _, n = w_mask.shape[:3]
    a8 = unpack_planes(a_mask).reshape(k_i * m, -1).to(torch.int8)
    if a8.shape[0] <= 16:
        a8 = torch.nn.functional.pad(a8, (0, 0, 0, 24 - a8.shape[0]))
    w8 = unpack_planes(w_mask).permute(1, 3, 0, 2).reshape(-1, k_w * n)
    return a8, w8.to(torch.int8)


def k3_phase(torch, rec: dict, device: str = "cuda") -> None:
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm import pack_scalars

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    u = 2.0 ** -24
    sms = k3.sm_count(dev)
    bodies: dict = {}
    cases = [(m, k, n, 8) for m in K3_MS for k, n in PROJ_KN]
    cases += [(m, k, n, 8) for m in RWKV_MS for k, n in RWKV_KN]
    cases += [(m, k, n, 8) for m, k, n in WHISPER_PATH]
    cases += [(m, k, n, 8) for m in GRANITE_MS for k, n in GRANITE_KN]
    cases += [(m, k, n, 8) for m in JAMBA_MS for k, n in JAMBA_KN]
    cases += [(3, 300, 130, 8), K3_NARROW]
    for (m, k, n, bits) in cases:
        a_mask, w_mask = k3_operands(torch, gen, m, k, n, dev, bits)
        g = -(-k // 128)
        sp = k3.plan(m, g, n, bits, bits, sms)
        bodies.setdefault(sp.body, []).append(
            f"{m}x{k}x{n}/{sp.split}")
        for name, regs, unit in K3_REGS:
            p = make_params(device=dev, **regs) if regs else None
            s = pack_scalars(p, dev)
            kw = dict(lossless=p is None, per_output=True)
            if p is not None:
                kw.update(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu,
                          mode=p.mode)
            acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s, **kw)
            acc_r, ops_r, per_r = plain_k3(torch, a_mask, w_mask, s, **kw)
            ctrl = f64_control(torch, a_mask, w_mask, p)
            torch.cuda.synchronize()
            if int(ops) != int(ops_r) or not torch.equal(per, per_r):
                raise AssertionError(f"K3 op counts differ at {m}x{k}x{n} "
                                     f"{name}: {int(ops)} vs {int(ops_r)}")
            exact = ctrl < 2.0 ** 24 * unit       # every partial sum exact
            same = acc == acc_r
            bar = bits * bits * g * u * ctrl
            err = (acc.double() - ctrl).abs()
            err_r = (acc_r.double() - ctrl).abs()
            n_exact = int(exact.sum())
            n_same = int(same.sum())
            ok = (bool(same[exact].all()) and bool((err <= bar).all())
                  and bool((err_r <= bar).all())
                  and bool(torch.isfinite(acc).all()))
            worst = float((acc - acc_r).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], worst)
            line = (f"  {m:>3}x{k:>5}x{n:>5} {bits}b {sp.body}/split "
                    f"{sp.split} {name:>10}: ops {int(ops)} "
                    f"equal (per output too); y bitwise equal to plain at "
                    f"{n_same}/{acc.numel()} ({n_exact} in the exact "
                    f"region), max |K3 - plain| {worst:.3e}, max |K3 - "
                    f"f64| {float(err.max()):.3e} (bar at the worst "
                    f"element {float(bar.flatten()[err.argmax()]):.3e})")
            if not ok:
                raise AssertionError("K3 outside its bar:" + line)
            if name == "default" and bits == 8 and (
                    (k, n) in PROJ_KN and m in K3_TIMED_MS or
                    (m, k, n) in RWKV_PATH or (m, k, n) in WHISPER_PATH
                    or (m, k, n) in GRANITE_PATH
                    or (m, k, n) in JAMBA_PATH):
                kw_main = dict(kw, per_output=False)
                kern = lambda: k3.xbar_mvm_cuda(  # noqa: E731
                    a_mask, w_mask, s, **kw_main)
                ms = device_ms(torch, kern, 20, flush)
                per_call = call_ms(torch, kern, 20, flush)
                plain = device_ms(torch, lambda: plain_k3(
                    torch, a_mask, w_mask, s, **kw_main), 3, flush)
                a8, w8 = int_mm_planes(torch, a_mask, w_mask)
                mm_ms = device_ms(torch, lambda: torch._int_mm(a8, w8), 20,
                                  flush)
                del a8, w8
                b, by = k3_bound(m, k, n)
                rec["shapes"].append(dict(shape=[m, k, n], ms=ms,
                                          call_ms=per_call, plain_ms=plain,
                                          bound_ms=b, bound_by=by,
                                          int_mm_ms=mm_ms, body=sp.body,
                                          split=sp.split))
                line += (f"; {ms:.4f} ms on the device, {per_call:.4f} ms "
                         f"per call (plain {plain:.4f} ms, bound {b:.4f} ms "
                         f"by {by}; yardstick torch._int_mm on the 0/1 "
                         f"planes, no conversion, {mm_ms:.4f} ms)")
            log(line)
            del acc, acc_r, ctrl, err, err_r, per, per_r
        del a_mask, w_mask
        torch.cuda.empty_cache()
    for body, shapes in sorted(bodies.items()):
        log(f"  body {body} (MxKxN/split): {', '.join(shapes)}")


# ---------------------------------------------------------------------------
# phases 7 and 8: the bit-exact datapath at full width, then Algorithm 1
# ---------------------------------------------------------------------------

def regs(c):
    """A calibration's chosen registers, as compared across routes."""
    p = c.params
    return (c.chosen, p.mode, p.n_r1, p.n_r2, p.m, p.nu,
            float(p.delta_r1), float(p.bias))


@contextlib.contextmanager
def plain_kernels():
    """Route K2 and K3 to their plain versions on the card (the package
    dispatches by device and has no such switch); K3's a column block at a
    time (:func:`plain_k3`: the same bits, within ``PLAIN_BYTES`` of
    bit-line sums, which 1,500 frame rows would pass 6x at once)."""
    import torch
    from repro_torch.kernels.trq_quant import ops as k2_ops
    from repro_torch.kernels.trq_quant.ref import trq_quant_ref, \
        trq_score_ref
    from repro_torch.kernels.xbar_mvm import ops as k3_ops
    saved = k2_ops.trq_quant_cuda, k2_ops.trq_score_cuda, \
        k3_ops.xbar_mvm_cuda
    k2_ops.trq_quant_cuda, k2_ops.trq_score_cuda, k3_ops.xbar_mvm_cuda = \
        trq_quant_ref, trq_score_ref, \
        lambda a, w, s, **kw: plain_k3(torch, a, w, s, **kw)
    try:
        yield
    finally:
        k2_ops.trq_quant_cuda, k2_ops.trq_score_cuda, \
            k3_ops.xbar_mvm_cuda = saved


def bit_exact_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch import runtime
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.registry import init

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
    rec["launches_by_path"][cfg.name] = run["launches"]
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
    # the profiler's split of the same two forwards: K3, the rest of the
    # projections (PTQ chain, activation packing, zero-point correction),
    # attention, and the device-idle share
    out["profile"] = profile_forwards(torch, rt, prompts[0])

    out.update(plain_k3_check(torch, rt, prompts[0], 256))
    return out


def plain_k3_check(torch, rt, prompt, max_len: int, extra=None) -> dict:
    """One full-width prefill of ``prompt`` (and ``extra``) on
    ``bit_exact`` (``rt``) through K3 and through its plain version:
    finite logits, relative L2 within ``BIT_EXACT_REL_BAR``, the same
    argmax, equal A/D ops."""
    toks = prompt[None].astype("int32")
    (l_k, _), rep_k = rt.prefill(toks, extra, max_len=max_len)
    with plain_kernels():
        t1 = time.perf_counter()
        (l_p, _), rep_p = rt.prefill(toks, extra, max_len=max_len)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    rel = rel_l2(l_k, l_p)
    same_top = bool((l_k.argmax(-1) == l_p.argmax(-1)).all())
    frames = f" with {extra['embeds'].shape[1]} frames" if extra else ""
    log(f"  {len(prompt)}-token prefill{frames}, K3 vs its plain version "
        f"({plain_s:.1f} s): "
        f"logits relative L2 {rel:.3e} (bar {BIT_EXACT_REL_BAR:.0e}), "
        f"bitwise {torch.equal(l_k, l_p)}, same argmax {same_top}, ad_ops "
        f"{rep_k.total():.0f} vs {rep_p.total():.0f}")
    if tuple(l_k.shape) != (1, rt.cfg.vocab_size) or not bool(
            torch.isfinite(l_k).all()):
        raise AssertionError("bit_exact logits not finite or misshapen")
    if rel > BIT_EXACT_REL_BAR or not same_top or \
            rep_k.total() != rep_p.total():
        raise AssertionError("K3 and its plain version disagree at full "
                             "width")
    return dict(plain_logit_rel_l2=rel, plain_same_argmax=same_top)


def calibrate_phase(torch, rec: dict, cfg, device: str = "cuda") -> dict:
    from repro_torch import runtime
    from repro_torch.core import calibrate as calibrate_mod
    from repro_torch.core.calibrate import _subsample, calibrate_layer, \
        summarize, to_quant_state
    from repro_torch.kernels.trq_quant import kernel as k2, score_table, \
        trq_score
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

    # -- the main path: every projection calibrated through K2's scoring
    # entry, one launch a layer; each layer's subsample is kept
    k2.LAUNCHES = k2.SCORE_LAUNCHES = 0
    kept, cal, collect_s = {}, {}, 0.0
    t0 = time.perf_counter()
    for _, lin in lins:
        t1 = time.perf_counter()
        kept[lin.name] = _subsample(samples(lin))
        torch.cuda.synchronize()
        collect_s += time.perf_counter() - t1
        cal[lin.name] = calibrate_layer(kept[lin.name], n_max=7)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    launches = dict(trq_score=k2.SCORE_LAUNCHES, trq_quant=k2.LAUNCHES)
    rec["launches"] = sum(launches.values())
    rec["launches_by_entry"] = launches
    summ = summarize(cal)
    kinds = {}
    for c in cal.values():
        key = (c.chosen, c.dist.kind)
        kinds[key] = kinds.get(key, 0) + 1
    log(f"  calibrated {summ['layers']} layers in {cal_s:.2f} s (collecting "
        f"and subsampling the bit-line sums {collect_s:.2f} s of it) "
        f"through {launches['trq_score']} K2 scoring launches and "
        f"{launches['trq_quant']} elementwise ones: {summ['twin_layers']} "
        f"twin, mean {summ['mean_ops']:.3f} ops per conversion (ratio to "
        f"8b {summ['op_ratio_vs_8b']:.3f}); (chosen, distribution): "
        f"{sorted(kinds.items())}")
    if launches != dict(trq_score=len(lins), trq_quant=0) or \
            summ["layers"] != len(lins):
        raise AssertionError(f"calibration did not score each layer in one "
                             f"K2 launch: {launches} for {len(lins)} layers")
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

    # -- plain scoring picks the same registers on every layer -------------
    with plain_kernels():
        t1 = time.perf_counter()
        plain = {n: calibrate_layer(y, n_max=7) for n, y in kept.items()}
        plain_s = time.perf_counter() - t1
    differ = [n for n in kept if regs(plain[n]) != regs(cal[n])]
    for n in differ:
        log(f"    {n}: K2 scoring chose {regs(cal[n])}, plain scoring "
            f"{regs(plain[n])}")
    if differ:
        raise AssertionError(f"plain scoring picked other registers on "
                             f"{len(differ)} of {len(kept)} layers")
    log(f"  plain scoring picked identical registers on all {len(kept)} "
        f"layers ({plain_s:.1f} s on the kept samples)")

    # -- the elementwise route (f32 sums, one elementwise launch a
    # candidate) on the same samples: a pick it makes differently must be
    # an exact tie
    saved = calibrate_mod._scores
    calibrate_mod._scores = lambda y, cands: elementwise_scores(torch, y,
                                                                cands)
    try:
        t1 = time.perf_counter()
        elem = {n: calibrate_layer(y, n_max=7) for n, y in kept.items()}
        torch.cuda.synchronize()
        elem_s = time.perf_counter() - t1
    finally:
        calibrate_mod._scores = saved
    moved = [n for n in kept if regs(elem[n]) != regs(cal[n])]
    for n in moved:
        sq, ops = trq_score(kept[n], *score_table(
            [cal[n].params, elem[n].params], kept[n].device))
        sums = [(float(a), int(b)) for a, b in zip(sq.cpu(), ops.cpu())]
        log(f"    {n}: picks {regs(cal[n])}, the elementwise route "
            f"{regs(elem[n])}; exact sums (squared error, ops) "
            f"{sums[0]!r} and {sums[1]!r}")
        if sums[0] != sums[1]:
            raise AssertionError(f"{n}: the elementwise route picked another "
                                 f"candidate, and not on an exact tie")
    log(f"  the elementwise route ({elem_s:.2f} s of scoring on the kept "
        f"samples, against {cal_s - collect_s:.2f} s now) picked the same "
        f"registers on {len(kept) - len(moved)} of {len(kept)} layers; "
        f"{len(moved)} exact ties broken otherwise")
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
    return qs, dict(layers=summ["layers"], twin_layers=summ["twin_layers"],
                mean_ops=summ["mean_ops"], calibrate_s=cal_s,
                collect_s=collect_s, k2_launches=launches,
                plain_checked=len(kept), plain_s=plain_s,
                elementwise_route_s=elem_s, elementwise_ties=len(moved),
                tokens_per_s=run["tokens_per_s"],
                mean_ttft_ms=run["mean_ttft_ms"],
                total_ad_ops=run["total_ad_ops"], conversions=conversions,
                uniform8_ad_ops=uniform8, adc_op_ratio=ratio,
                forwards=run["forwards"], k3_launches=run["launches"])


# ---------------------------------------------------------------------------
# phases 9 and 10: the serve bench, then the noise seam
# ---------------------------------------------------------------------------

def serve_bench_phase(torch, cfg, qs, device: str = "cuda") -> dict:
    """``benchmarks/serve_bench_torch.py``'s shared-prefix chat (quick:
    4 requests, 4 new tokens, max batch 2) at full width on ``pallas`` and
    ``bit_exact``, reuse on and off; the census on one forward; then
    ``Runtime.save`` of phase 8's registers read back."""
    import tempfile
    from benchmarks import serve_bench_torch as sb
    from repro_torch.core.quant_state import (load_quant_state,
                                              quant_state_to_dict)
    from repro_torch.pim import ad_ops_tally
    from repro_torch.serve import ServeEngine

    out = {}
    for backend in ("pallas", "bit_exact"):
        built = sb.build(sb.ARCH, backend, device)
        rt = built[1]
        if (rt.cfg.n_layers, rt.cfg.d_model) != (cfg.n_layers, cfg.d_model):
            raise AssertionError("the serve bench did not run full width")
        rec = sb.shared_prefix_chat(built, quick=True)
        log(f"  {backend}: {rec['requests']} requests, "
            f"{rec['tokens_per_s']:.2f} tok/s, mean ttft "
            f"{1e3 * rec['mean_ttft_s']:.1f} ms, "
            f"{rec['mean_ad_ops_per_request']:.0f} A/D ops per request; "
            f"without reuse {rec['no_reuse_tokens_per_s']:.2f} tok/s, ttft "
            f"{1e3 * rec['no_reuse_mean_ttft_s']:.1f} ms; prefix reuse "
            f"saves {rec['reuse_ad_ops_saved_frac']:.4f} of "
            f"{rec['no_reuse_total_ad_ops']:.0f} A/D ops; greedy tokens "
            f"equal with and without reuse: "
            f"{rec['reuse_tokens_identical']} (a reading: the suffix-only "
            f"prefill and the batch-wide dynamic scales change the "
            f"quantization grid, in the reference as here)")
        if rec["reused_prompt_tokens"] != 3 * 48:
            raise AssertionError(f"{backend}: the shared prefix was not "
                                 f"reused")
        # the census on one forward: a prefill-only request
        eng = ServeEngine(rt, max_batch=1, max_len=128)
        eng.submit(sb.chat_prompts(cfg.vocab_size, True)[0],
                   max_new_tokens=1)
        with ad_ops_tally() as census:
            eng.run()
        layer_sum = census.total()
        engine_total = eng.stats()["total_ad_ops"]
        log(f"  census of one prefill: {len(census.by_layer)} names "
            f"(period-local, each summing {cfg.n_layers} layers), layer sum "
            f"{layer_sum:.0f}, engine total {engine_total:.0f}")
        if layer_sum != engine_total or \
                len(census.by_layer) != PROJ_PER_LAYER:
            raise AssertionError(f"{backend}: the census does not add up "
                                 f"to the engine's total")
        rec["census_layer_sum"] = layer_sum
        out[backend] = rec
        del built, eng
        torch.cuda.empty_cache()

    # Runtime.save -> load_quant_state round-trips phase 8's registers
    rt_q = rt.with_overrides(quant_state=qs, plan=False)
    with tempfile.TemporaryDirectory() as d:
        back = load_quant_state(rt_q.save(d))
    del rt, rt_q
    same = quant_state_to_dict(back) == quant_state_to_dict(qs)
    names = [f"layer_{i}/{w}" for i in range(cfg.n_layers)
             for w in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                       "mlp/w_gate", "mlp/w_up", "mlp/w_down")]
    regs = all(_regs(back.lookup(n)) == _regs(qs.lookup(n)) for n in names)
    log(f"  Runtime.save -> load: {len(qs)} rules, file equal {same}, "
        f"registers equal on {len(names)} layers {regs}")
    if not (same and regs):
        raise AssertionError("Runtime.save did not round-trip the "
                             "calibrated QuantState")
    out["save_roundtrip_rules"] = len(qs)

    # the full mixed-archs scenario on pallas: llama3.2-3b, rwkv6-7b and
    # whisper-medium (8 zero frames a prompt) at full width, one at a time
    built = sb.build(sb.ARCH, "pallas", device)
    mixed = sb.mixed_archs(built, quick=False)
    del built
    torch.cuda.empty_cache()
    for arch, r in mixed["archs"].items():
        log(f"  mixed_archs {arch}: {r['requests']} requests, "
            f"{r['decode_tokens']} tokens, {r['tokens_per_s']:.2f} tok/s, "
            f"mean ttft {1e3 * r['mean_ttft_s']:.1f} ms, "
            f"{r['mean_ad_ops_per_request']:.0f} A/D ops per request")
    if sorted(mixed["archs"]) != sorted([sb.ARCH, sb.RECURRENT_ARCH,
                                         sb.ENCDEC_ARCH]) or \
            mixed["pending_archs"] or any(
                r["decode_tokens"] != 3 * MIXED_NEW
                for r in mixed["archs"].values()):
        raise AssertionError("mixed_archs did not serve all three archs")
    out["mixed_archs"] = mixed
    return out


def _regs(p):
    return None if p is None else (p.mode, p.n_r1, p.n_r2, p.m, p.nu,
                                   p.signed, float(p.delta_r1),
                                   float(p.bias))


# a device with every fault kind, used at the smoke config and on one
# full-width layer
NOISE_MODEL = dict(g_sigma=0.1, sa0=0.01, sa1=0.005, read_sigma=0.3,
                   ir_drop=0.05, adc_offset=0.2, adc_sigma=0.1, seed=11)
BOUND_Z = 6.0     # phase 10: a drawn rate or sigma within 6 standard errors


def drawn_rates(torch, planes, analog) -> dict:
    """The SA0 and SA1 rates and the relative conductance sigma drawn into
    ``analog`` from ideal 0/1 ``planes`` (SA0 pins a 1-cell to exactly 0,
    SA1 a 0-cell to exactly 1; variation leaves a 0-cell at 0)."""
    ones = planes == 1
    g1 = analog[ones]
    sa0 = (g1 == 0).double().mean().item()
    sa1 = (analog[~ones] == 1).double().mean().item()
    moved = g1[(g1 != 0) & (g1 != 1)]
    return dict(sa0=sa0, sa1=sa1, g_sigma=(moved.double() - 1).std().item(),
                n_sa0=int(ones.sum()), n_sa1=int((~ones).sum()),
                n_g_sigma=moved.numel())


def noise_phase(torch, cfg_be, device: str = "cuda") -> dict:
    """Null and all-zero CrossbarModels against bit_exact at full width (the
    ``xbar_mvm`` kernel must run), a seeded model reproducing at the smoke
    config, and the fault rates drawn on one full-width layer."""
    import math
    import numpy as np
    from repro_torch import runtime
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.registry import get_config, init
    from repro_torch.pim import CrossbarModel, pim_mvm, prepare_linear
    from repro_torch.pim.backend import ptq_int, ptq_scale
    from repro_torch.pim.crossbar import PimConfig, weight_planes
    from repro_torch.pim.noise import (adc_offsets, perturb_planes,
                                       perturb_psums, value_salt)

    out = {}
    state = init(cfg_be, seed=0, device=device)
    rt_be = runtime.compile(cfg_be, state, device=device)
    toks = trace_prompts(cfg_be)[0][None].astype(np.int32)
    (l_be, _), r_be = rt_be.prefill(toks, max_len=128)
    x = torch.randn((4, cfg_be.d_model), generator=torch.Generator(
        device=device).manual_seed(0), device=device).to(torch.bfloat16)
    y_be, m_be = rt_be.mvm(x, "layer_0/mlp/w_gate")
    for label, model in (("null", None), ("all-zero", CrossbarModel())):
        rt_n = rt_be.with_overrides(backend="noisy", crossbar_model=model)
        k3.LAUNCHES = 0
        (l_n, _), r_n = rt_n.prefill(toks, max_len=128)
        y_n, m_n = rt_n.mvm(x, "layer_0/mlp/w_gate")
        torch.cuda.synchronize()
        launches = k3.LAUNCHES
        ok = (torch.equal(l_n, l_be) and r_n.total() == r_be.total()
              and torch.equal(y_n, y_be) and m_n.total() == m_be.total())
        log(f"  {label} model, full width: prefill logits and ad_ops "
            f"({r_n.total():.0f}) and one w_gate y and ad_ops bitwise equal "
            f"to bit_exact: {ok}; K3 launches {launches}")
        if not ok or launches != PROJ_PER_LAYER * cfg_be.n_layers + 1:
            raise AssertionError(f"the {label} CrossbarModel is not "
                                 f"bit_exact through K3")
        del rt_n
    out["null_identity"] = 1.0
    w = rt_be.model.layers[0].mlp.w_gate.w
    del rt_be, state
    torch.cuda.empty_cache()

    # -- a seeded model reproduces itself at the smoke config ---------------
    cfg_s = get_config(ARCH, smoke=True).replace(
        remat="none", pim_backend="noisy")
    model = CrossbarModel(**NOISE_MODEL)
    s_state = init(cfg_s, seed=0, device=device)
    s_toks = np.random.default_rng(0).integers(0, cfg_s.vocab_size, (1, 16))
    runs = []
    for plan in (True, True, None):
        rt_s = runtime.compile(cfg_s, s_state, device=device, plan=plan,
                               crossbar_model=model)
        (lg, _), rep = rt_s.prefill(s_toks, max_len=32)
        runs.append((lg, rep.total()))
    (lg0, _), rep0 = runtime.compile(cfg_s.replace(pim_backend="bit_exact"),
                                     s_state, device=device).prefill(
        s_toks, max_len=32)
    same = all(torch.equal(lg, runs[0][0]) and ops == runs[0][1]
               for lg, ops in runs[1:])
    div = rel_l2(runs[0][0], lg0)
    log(f"  seeded model, smoke config: two compiled runs and the dynamic "
        f"path bitwise equal: {same}; logits relative L2 to bit_exact "
        f"{div:.4f}; ad_ops {runs[0][1]:.0f} vs {rep0.total():.0f}")
    if not same or not math.isfinite(div):
        raise AssertionError("a seeded CrossbarModel did not reproduce")
    out.update(smoke_reproduces=1.0, smoke_rel_l2=div)

    # -- one full-width layer on the non-null path: the dynamic call and a
    # baked plan agree bit for bit, at the closed-form op count -----------
    xw = torch.randn((4, w.shape[0]), generator=torch.Generator(
        device=device).manual_seed(1), device=device).to(w.dtype)
    dyn = pim_mvm(xw, w, None, backend="noisy", crossbar_model=model)
    lp = prepare_linear(w, None, backend="noisy", crossbar_model=model)
    prep = pim_mvm(xw, plan=lp, crossbar_model=model)
    ideal = pim_mvm(xw, w, None, backend="bit_exact")
    torch.cuda.synchronize()
    want_ops = 8 * SLICES * -(-w.shape[0] // 128) * 4 * w.shape[1]
    same = torch.equal(dyn.y, prep.y) and int(dyn.ad_ops) == int(
        prep.ad_ops) == want_ops
    rel = rel_l2(dyn.y.float(), ideal.y.float())
    log(f"  one full-width w_gate {tuple(xw.shape)} x {tuple(w.shape)} "
        f"under the model: dynamic and baked plan ({lp.w_analog.numel()} "
        f"f32 cells) bitwise equal {same}, {int(dyn.ad_ops)} A/D ops "
        f"(closed form {want_ops}), relative L2 to bit_exact {rel:.4f}")
    if not same or not math.isfinite(rel):
        raise AssertionError("the noisy path disagrees with its plan at "
                             "full width")
    out["layer_rel_l2"] = rel
    del lp, dyn, prep, ideal

    # -- the faults drawn on one full-width layer ----------------------------
    pim = PimConfig()
    wf = w.float()
    w_int = ptq_int(wf, ptq_scale(wf, pim.k_w), pim.k_w)
    planes = weight_planes(w_int, pim)
    salt = value_salt(w_int)
    analog = perturb_planes(planes, model, salt)
    got = drawn_rates(torch, planes, analog)
    off = adc_offsets(model, salt, planes.shape[:2] + planes.shape[3:],
                      device)
    got.update(adc_offset=off.double().std().item(), n_adc_offset=off.numel())
    p = perturb_psums(torch.zeros((8, 8, planes.shape[1], 4,
                                   planes.shape[3]), device=device),
                      model.replace(ir_drop=0.0, adc_sigma=0.0), pim)
    got.update(read_sigma=p.double().std().item(), n_read_sigma=p.numel())
    del analog, planes, p
    bad = []
    for f in ("sa0", "sa1", "g_sigma", "adc_offset", "read_sigma"):
        want, n = NOISE_MODEL[f], got[f"n_{f}"]
        # binomial standard error of a rate; 1/sqrt(2n) relative of a sigma
        se = math.sqrt(want * (1 - want) / n) if f.startswith("sa") else \
            want / math.sqrt(2 * n)
        log(f"  {f}: drew {got[f]:.6f} from {n} samples against {want} "
            f"(bound +-{BOUND_Z * se:.6f})")
        if abs(got[f] - want) > BOUND_Z * se:
            bad.append(f)
    if bad:
        raise AssertionError(f"drawn faults off their parameters: {bad}")
    out["drawn"] = {k: got[k] for k in ("sa0", "sa1", "g_sigma",
                                        "adc_offset", "read_sigma")}
    return out


# ---------------------------------------------------------------------------
# phase 11: full-width rwkv6-7b
# ---------------------------------------------------------------------------

def decode_shares(n_req: int, max_batch: int, new: int) -> list:
    """For each request of a greedy trace with ``new`` tokens each (the
    first from its prefill), admitted in order into ``max_batch`` slots:
    the sum, over the decode steps it rode, of 1 / (requests active in the
    step) -- the engine splits a step's conversions (all ``max_batch``
    rows, idle ones included) evenly over its active requests."""
    left, queue, active = [new - 1] * n_req, list(range(n_req)), []
    shares = [0.0] * n_req
    while queue or active:
        while queue and len(active) < max_batch:
            active.append(queue.pop(0))
        for r in active:
            shares[r] += 1.0 / len(active)
            left[r] -= 1
        active = [r for r in active if left[r] > 0]
    return shares


def bucket(n: int, max_len: int) -> int:
    """The engine's prefill length: the power of two >= n, at least 8."""
    return min(max(8, 1 << (n - 1).bit_length()), max_len)


def rwkv_conversions(cfg):
    """(conversions of a token row through every projection and the
    ``lm_head``, of a prefill row that stops before the ``lm_head``): N x
    ceil(K/128) per projection."""
    d, f = cfg.d_model, cfg.d_ff
    layer = 5 * d * -(-d // 128) + 2 * f * -(-d // 128) + d * -(-f // 128)
    prefill = cfg.n_layers * layer
    return prefill + cfg.vocab_size * -(-d // 128), prefill


def mixed_trace(torch, built, counter, kname: str, slices: int) -> dict:
    """The serve bench's mixed-archs trace (``benchmarks/serve_bench_torch
    .py``: prompts of 12, 24 and 7 tokens, 6 new tokens, max_len 64, max
    batch 2) through its own ``serve``, with ``counter.LAUNCHES`` set to 0
    just before and read just after.  Fails unless every forward launched
    the kernel 257 times, every request's A/D ops equal the closed form
    (``slices`` bit-line conversions per crossbar group and output, 7 ops
    each) and every request got 6 in-vocab tokens."""
    from benchmarks import serve_bench_torch as sb
    cfg, rt = built
    prompts = sb.mixed_prompts(cfg.vocab_size)
    counter.LAUNCHES = 0
    calls0 = rt.forward_calls
    rec, eng = sb.serve(built, prompts, max_new=MIXED_NEW,
                        max_batch=MIXED_BATCH, max_len=64)
    launches = counter.LAUNCHES
    calls = rt.forward_calls - calls0
    done = sorted(eng.finished, key=lambda r: r.uid)
    per_conv = 7 * slices
    row, prefill_row = rwkv_conversions(cfg)
    ok = len(done) == len(prompts)
    per_req = []
    for r, share in zip(done, decode_shares(len(prompts), MIXED_BATCH,
                                            MIXED_NEW)):
        p = bucket(len(r.prompt), 64)
        pre = per_conv * (prefill_row * p + row - prefill_row)
        want = pre + per_conv * row * MIXED_BATCH * share
        ok = ok and r.prefill_ad_ops == pre and r.ad_ops == want and \
            len(r.generated) == MIXED_NEW and all(
                0 <= t < cfg.vocab_size for t in r.generated)
        per_req.append(r.ad_ops)
        log(f"  req {r.uid}: {len(r.prompt)}-token prompt (bucket {p}), "
            f"ttft {1e3 * (r.first_token_t - r.submit_t):.1f} ms, ad_ops "
            f"{r.ad_ops:.0f} (closed form {want:.0f}; prefill "
            f"{r.prefill_ad_ops:.0f}, closed form {pre}), tokens "
            f"{list(r.generated)}")
    per_fwd = cfg.n_layers * RWKV_PROJ_PER_LAYER + 1
    log(f"  served {rec['requests']} requests, {rec['decode_tokens']} "
        f"tokens in {rec['wall_s']:.2f} s: {rec['tokens_per_s']:.2f} tok/s, "
        f"mean ttft {1e3 * rec['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{rec['total_ad_ops']:.0f}, {calls} forwards, {kname} launches "
        f"{launches} (expected {per_fwd} x {calls})")
    if launches != per_fwd * calls or calls == 0:
        raise AssertionError(f"{kname} launched {launches} times for "
                             f"{calls} forwards; expected {per_fwd} each")
    if not ok:
        raise AssertionError("rwkv6: A/D ops per request off the closed "
                             "form, or tokens missing")
    return dict(tokens_per_s=rec["tokens_per_s"],
                mean_ttft_ms=1e3 * rec["mean_ttft_s"],
                total_ad_ops=rec["total_ad_ops"], ad_ops_per_request=per_req,
                forwards=calls, launches=launches, wall_s=rec["wall_s"],
                tokens=[list(r.generated) for r in done])


def recurrence_check(torch, rt, device: str = "cuda") -> dict:
    """The chunked WKV scan of a prefill is the per-token recurrence: at
    the model's head shapes (2 sequences of 45 tokens, a padded last chunk,
    seeded r, k, v, log-decays across ``decay_w``'s range, from a zero and
    a nonzero state) and through layer 0's time-mix on the ``exact``
    datapath in f32 (one 45-token prefill against 45 single-token decode
    steps from the zero cache).  Relative L2 of the outputs and the carried
    ``s`` within ``WKV_TOL``; ``x_prev`` bitwise."""
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import PimContext
    cfg = rt.cfg
    h, hs = rwkv6.dims(cfg)
    t_len = 45
    gen = torch.Generator(device=device).manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (randn(2, h, t_len, hs) for _ in range(3))
    base = torch.linspace(-6.0, -1.0, h * hs, device=device).reshape(h, hs)
    logw = -torch.exp(base[None, :, None] + 0.5 * randn(2, h, t_len, hs))
    u = randn(h, hs)
    errs = {}
    for label, s0 in (("zero", torch.zeros(2, h, hs, hs, device=device)),
                      ("warm", randn(2, h, hs, hs))):
        out, s_end = rwkv6.wkv(r, k, v, logw, u, s0, cfg.rwkv_chunk)
        st, steps = s0, []
        for t in range(t_len):
            o, st = rwkv6.wkv_step(r[:, :, t], k[:, :, t], v[:, :, t],
                                   logw[:, :, t], u, st)
            steps.append(o)
        errs[f"wkv_{label}_out"] = rel_l2(out, torch.cat(steps, 2))
        errs[f"wkv_{label}_s"] = rel_l2(s_end, st)

    mix = rt.model.layers[0].rwkv
    ctx = PimContext(cfg.replace(dtype="float32"), "exact", device=device)
    x = randn(1, t_len, cfg.d_model)
    zero = {"s": torch.zeros(1, h, hs, hs, device=device),
            "x_prev": torch.zeros(1, 1, cfg.d_model, device=device)}
    with torch.no_grad():
        y, c_pre = mix(x, ctx, cache=zero)
        c, ys = zero, []
        for t in range(t_len):
            y1, c = mix(x[:, t:t + 1], ctx, cache=c)
            ys.append(y1)
    errs["mix_out"] = rel_l2(y, torch.cat(ys, 1))
    errs["mix_s"] = rel_l2(c_pre["s"], c["s"])
    same_x = torch.equal(c_pre["x_prev"], c["x_prev"])
    log(f"  chunked scan against the recurrence ({t_len} tokens, "
        f"{h} heads of {hs}, chunk {cfg.rwkv_chunk}): relative L2 "
        + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items())
        + f" (bar {WKV_TOL:.0e}); x_prev bitwise {same_x}")
    if max(errs.values()) > WKV_TOL or not same_x:
        raise AssertionError("the chunked WKV scan and the recurrence "
                             "disagree")
    return errs


def rwkv_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(RWKV_ARCH).replace(param_dtype="bfloat16",
                                        pim_backend="pallas", remat="none")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings) == (RWKV_LAYERS, 4096, 14336, 65536, False)
    assert rwkv_conversions(cfg) == (RWKV_ROW, RWKV_PREFILL_ROW)
    return cfg


def rwkv6_phase(torch, rec1: dict, rec3: dict, cfg,
                device: str = "cuda") -> dict:
    """rwkv6-7b at ``cfg`` on ``pallas`` through K1, then on ``bit_exact``
    through K3 (see the module docstring, phase 11)."""
    from benchmarks import serve_bench_torch as sb
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.xbar_mvm import kernel as k3

    torch.cuda.reset_peak_memory_stats()
    rt, gib = compile_pallas(torch, cfg, device)
    n_params = sum(t.numel() for t in rt.model.state_dict().values())
    log(f"  {n_params / 1e9:.3f} B parameters")
    out = dict(params=n_params, gib_after_compile=gib)
    prompt = sb.mixed_prompts(cfg.vocab_size)[1]          # 24 tokens
    runs = {}
    for backend, counter, kname, slices in (("pallas", k1, "K1", 1),
                                            ("bit_exact", k3, "K3",
                                             SLICES)):
        if backend == "bit_exact":
            t0 = time.perf_counter()
            rt = rt.with_overrides(backend="bit_exact")
            torch.cuda.synchronize()
            g = 2 ** 30
            log(f"  programmed {len(rt.plan)} bit_exact layer plans in "
                f"{time.perf_counter() - t0:.1f} s; "
                f"{torch.cuda.memory_allocated() / g:.2f} GiB allocated, "
                f"peak {torch.cuda.max_memory_allocated() / g:.2f} GiB")
            warm(rt)
        run = runs[backend] = mixed_trace(torch, (cfg, rt), counter, kname,
                                          slices)
        run.update(forward_times(torch, rt, prompt, MIXED_BATCH, 64))
        log(f"  {backend}: one decode step (batch {MIXED_BATCH}) "
            f"{run['decode_step_ms']:.1f} ms, one {len(prompt)}-token "
            f"prefill {run[f'prefill{len(prompt)}_ms']:.1f} ms")
        run["profile"] = profile_forwards(torch, rt, prompt, MIXED_BATCH, 64)
        if backend == "pallas":
            out["recurrence"] = recurrence_check(torch, rt, device)
            log("  a full-width prefill, fake_quant against pallas (the "
                "phase-4 bar)")
            out.update(fake_quant_check(torch, rt, prompt, 64))
        else:
            run.update(plain_k3_check(torch, rt, prompt, 64))
    for rec, backend in ((rec1, "pallas"), (rec3, "bit_exact")):
        rec["launches_by_path"][RWKV_ARCH] = runs[backend]["launches"]
    out.update(runs)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# ---------------------------------------------------------------------------
# phase 12: full-width whisper-medium
# ---------------------------------------------------------------------------

def whisper_conversions(cfg):
    """(conversions of a frame row through the frame projection and the
    encoder, of the same row's cross-KV, of a decoder row) on ``pallas``:
    N x ceil(K/128) per projection; an encoder layer's count is held to
    :func:`conversions_per_token` less the ``w_gate`` it lacks."""
    d, f = cfg.d_model, cfg.d_ff
    assert cfg.n_heads * cfg.hd == cfg.n_kv_heads * cfg.hd == d
    proj = d * -(-d // 128)                    # any d -> d projection
    mlp = f * -(-d // 128) + d * -(-f // 128)  # w_up, w_down
    enc_layer = 4 * proj + mlp
    if enc_layer != conversions_per_token(cfg) - f * -(-d // 128):
        raise AssertionError("whisper's closed form disagrees with "
                             "conversions_per_token")
    return (proj + cfg.encoder_layers * enc_layer,
            cfg.n_layers * 2 * proj,
            cfg.n_layers * (6 * proj + mlp))


def whisper_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(WHISPER_ARCH).replace(param_dtype="bfloat16",
                                           pim_backend="pallas",
                                           remat="none")
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (
        WHISPER_LAYERS, WHISPER_LAYERS, 1024, 4096, 51865, True)
    assert whisper_conversions(cfg) == (WHISPER_FRAME_ROW, WHISPER_XKV_ROW,
                                        WHISPER_DEC_ROW)
    return cfg


def frame_feed(frames):
    """The engine's ``extra_inputs``: each prefill gets the next request's
    frames (admission order), a decode step nothing."""
    fed = [0]

    def extra_inputs(b: int, s: int) -> dict:
        if s == 1:
            return {}
        i, fed[0] = fed[0], fed[0] + 1
        return {"embeds": frames[i % len(frames)][None]}
    return extra_inputs


@contextlib.contextmanager
def launches_per_call(torch, rt, counter):
    """Record ``counter.LAUNCHES`` spent by each ``rt.prefill`` (a
    continued prefill's among them) and ``rt.decode`` call, and whether
    its logits are finite."""
    calls = {"prefill": [], "decode": [], "finite": True}

    def wrap(kind, fn):
        def inner(*a, **kw):
            before = counter.LAUNCHES
            (logits, cache), rep = fn(*a, **kw)
            calls[kind].append(counter.LAUNCHES - before)
            calls["finite"] &= bool(torch.isfinite(logits).all())
            return (logits, cache), rep
        return inner
    rt.prefill = wrap("prefill", rt.prefill)
    rt.prefill_cont = wrap("prefill", rt.prefill_cont)
    rt.decode = wrap("decode", rt.decode)
    try:
        yield calls
    finally:
        del rt.prefill, rt.prefill_cont, rt.decode


def whisper_trace(torch, rt, frames, counter, kname: str,
                  slices: int) -> dict:
    """Phase 12's trace (``WHISPER_*``) through the paged engine, with
    ``counter.LAUNCHES`` set to 0 just before and read just after.  Fails
    unless every prefill launched the kernel 385 times and every decode
    step 192, every request's A/D ops equal the closed form (``slices``
    bit-line conversions per group and output, 7 ops each), every logit
    was finite, every request got 32 in-vocab tokens and each held a page
    for every 16 of its 1,500 cross-KV rows."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    cfg = rt.cfg
    eng = ServeEngine(rt, max_batch=WHISPER_BATCH, max_len=WHISPER_MAX_LEN,
                      block_size=16, extra_inputs=frame_feed(frames))
    with launches_per_call(torch, rt, counter) as calls:
        counter.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(WHISPER_BATCH):
            eng.submit(np.array(WHISPER_PROMPT), max_new_tokens=WHISPER_NEW)
        done = sorted(eng.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counter.LAUNCHES
    st = eng.stats()
    per_conv = 7 * slices
    frame_row, xkv_row, dec_row = whisper_conversions(cfg)
    bkt = bucket(len(WHISPER_PROMPT), WHISPER_MAX_LEN)
    pre = per_conv * (WHISPER_FRAMES * (frame_row + xkv_row)
                      + bkt * dec_row)
    ok = len(done) == WHISPER_BATCH
    per_req = []
    for r, share in zip(done, decode_shares(WHISPER_BATCH, WHISPER_BATCH,
                                            WHISPER_NEW)):
        want = pre + per_conv * dec_row * WHISPER_BATCH * share
        ok = ok and r.prefill_ad_ops == pre and r.ad_ops == want and \
            len(r.generated) == WHISPER_NEW and all(
                0 <= t < cfg.vocab_size for t in r.generated)
        per_req.append(r.ad_ops)
        log(f"  req {r.uid}: ttft {1e3 * (r.first_token_t - r.submit_t):.1f}"
            f" ms, ad_ops {r.ad_ops:.0f} (closed form {want:.0f}; prefill "
            f"{r.prefill_ad_ops:.0f}, closed form {pre}), tokens "
            f"{list(r.generated)}")
    pages = -(-WHISPER_FRAMES // 16)
    peak = st["paged"]["peak_pages_in_use"]
    log(f"  served {st['requests']} requests, {st['decode_tokens']} tokens "
        f"in {wall:.2f} s: {st['tokens_per_s']:.2f} tok/s, mean ttft "
        f"{1e3 * st['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{st['total_ad_ops']:.0f}; {kname} launches {launches}: "
        f"{calls['prefill']} by the prefills, "
        f"{sorted(set(calls['decode']))} by each of "
        f"{len(calls['decode'])} decode steps; peak pages {peak} "
        f"({WHISPER_BATCH} x {pages} expected); logits finite "
        f"{calls['finite']}")
    if calls["prefill"] != [WHISPER_PREFILL_LAUNCHES] * WHISPER_BATCH or \
            set(calls["decode"]) != {WHISPER_DECODE_LAUNCHES} or \
            launches != sum(calls["prefill"]) + sum(calls["decode"]):
        raise AssertionError(f"whisper: {kname} launches per forward off "
                             f"{WHISPER_PREFILL_LAUNCHES} (prefill) / "
                             f"{WHISPER_DECODE_LAUNCHES} (decode)")
    if not ok or not calls["finite"] or peak != WHISPER_BATCH * pages:
        raise AssertionError("whisper: A/D ops per request off the closed "
                             "form, tokens missing, logits not finite or "
                             "cross-KV rows without pages")
    return dict(tokens_per_s=st["tokens_per_s"],
                mean_ttft_ms=1e3 * st["mean_ttft_s"],
                total_ad_ops=st["total_ad_ops"], ad_ops_per_request=per_req,
                forwards=len(calls["prefill"]) + len(calls["decode"]),
                launches=launches, wall_s=wall, peak_pages=peak,
                tokens=[list(r.generated) for r in done])


def whisper_forwards(torch, rt, frames, measure) -> dict:
    """``measure(label, fn)`` over one batch-4 decode step of the paged
    engine (the ``assemble`` of every slot's self- and cross-KV pages, the
    forward, the write-back, sampling) and one prefill of the prompt with
    1,500 frames."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(rt, max_batch=WHISPER_BATCH, max_len=WHISPER_MAX_LEN,
                      block_size=16, extra_inputs=frame_feed(frames))
    for _ in range(WHISPER_BATCH):
        eng.submit(np.array(WHISPER_PROMPT), max_new_tokens=WHISPER_NEW)
    eng._admit()
    prompt = np.array([WHISPER_PROMPT], np.int32)
    extra = {"embeds": frames[:1]}
    return {"decode_step": measure("decode_step", eng.step),
            f"prefill{WHISPER_FRAMES}": measure(
                f"prefill{WHISPER_FRAMES}", lambda: rt.prefill(
                    prompt, extra, max_len=WHISPER_MAX_LEN))}


def whisper_phase(torch, rec1: dict, rec3: dict, cfg,
                  device: str = "cuda") -> dict:
    """whisper-medium at ``cfg`` on ``pallas`` through K1, then on
    ``bit_exact`` through K3 (see the module docstring, phase 12)."""
    import numpy as np
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.xbar_mvm import kernel as k3

    torch.cuda.reset_peak_memory_stats()
    rt, gib = compile_pallas(torch, cfg, device)
    n_params = sum(t.numel() for t in rt.model.state_dict().values())
    log(f"  {n_params / 1e9:.3f} B parameters")
    if len(rt.plan) != WHISPER_PREFILL_LAUNCHES:
        raise AssertionError(f"whisper: {len(rt.plan)} layer plans, not "
                             f"{WHISPER_PREFILL_LAUNCHES}")
    gen = torch.Generator(device=device).manual_seed(12)
    frames = torch.randn(WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model,
                         generator=gen, device=device)
    prompt = np.asarray(WHISPER_PROMPT)
    out = dict(params=n_params, gib_after_compile=gib)
    runs = {}
    for backend, counter, kname, slices in (("pallas", k1, "K1", 1),
                                            ("bit_exact", k3, "K3",
                                             SLICES)):
        if backend == "bit_exact":
            t0 = time.perf_counter()
            rt = rt.with_overrides(backend="bit_exact")
            torch.cuda.synchronize()
            log(f"  programmed {len(rt.plan)} bit_exact layer plans in "
                f"{time.perf_counter() - t0:.1f} s; "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
                f"allocated")
            warm(rt)
        run = runs[backend] = whisper_trace(torch, rt, frames, counter,
                                            kname, slices)
        times = whisper_forwards(torch, rt, frames,
                                 lambda k, fn: wall_ms(torch, fn))
        run.update({f"{k}_ms": v for k, v in times.items()})
        log(f"  {backend}: one decode step of the engine (batch "
            f"{WHISPER_BATCH}) {run['decode_step_ms']:.1f} ms, one "
            f"{WHISPER_FRAMES}-frame prefill "
            f"{run[f'prefill{WHISPER_FRAMES}_ms']:.1f} ms")
        run["profile"] = whisper_forwards(torch, rt, frames,
                                          lambda k, fn: profile_one(
                                              torch, k, fn))
        extra = {"embeds": frames[:1]}
        if backend == "pallas":
            log("  a full-width prefill, fake_quant against pallas (the "
                "phase-4 bar, on the decoder stream)")
            out.update(fake_quant_check(torch, rt, prompt, WHISPER_MAX_LEN,
                                        extra))
        else:
            run.update(plain_k3_check(torch, rt, prompt, WHISPER_MAX_LEN,
                                      extra))
    for rec, backend in ((rec1, "pallas"), (rec3, "bit_exact")):
        rec["launches_by_path"][WHISPER_ARCH] = runs[backend]["launches"]
    out.update(runs)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# ---------------------------------------------------------------------------
# phase 13: full-width granite-moe-3b-a800m
# ---------------------------------------------------------------------------

def planned_conversions(model) -> int:
    """Conversions of one token row through every planned projection of
    ``model`` (``iter_linears``: the ``PimLinear``s, no expert FFN and no
    router): N x ceil(K/128) each."""
    from repro_torch.pim.plan import iter_linears
    return sum(lin.w.shape[1] * -(-lin.w.shape[0] // 128)
               for _, lin in iter_linears(model))


def granite_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(GRANITE_ARCH).replace(param_dtype="bfloat16",
                                           pim_backend="pallas",
                                           remat="none")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.n_experts, cfg.experts_per_token, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings) == (GRANITE_LAYERS, 1536, 24, 8, 64, 40, 8,
                                    512, 49155, True)
    return cfg


def granite_trace(torch, rt, counter, kname: str, slices: int,
                  reuse: bool) -> dict:
    """Phase 3's trace (:func:`trace_prompts`: 8 requests, a shared
    48-token prefix plus a 16-token tail, 16 new tokens, max batch 4,
    greedy) through the paged engine with prefix reuse on or off, with
    ``counter.LAUNCHES`` set to 0 just before and read just after.  Fails
    unless every forward (prefill, continued prefill, decode step)
    launched the kernel ``GRANITE_LAUNCHES`` times, every logit was
    finite, every request's A/D ops equal the closed form (7 ops a
    conversion, ``slices`` conversions per group and output, over its
    prefill's unreused rows and its share of every decode step's
    ``TRACE_BATCH`` rows), every request got 16 in-vocab tokens, and reuse
    served the prefix to the 7 later requests exactly when it was on."""
    from repro_torch.serve import ServeEngine
    cfg = rt.cfg
    eng = ServeEngine(rt, max_batch=TRACE_BATCH, max_len=256,
                      block_size=16, prefix_reuse=reuse)
    prompts = trace_prompts(cfg)
    with launches_per_call(torch, rt, counter) as calls:
        counter.LAUNCHES = 0
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        done = sorted(eng.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counter.LAUNCHES
    st = eng.stats()
    row = 7 * slices * planned_conversions(rt.model)
    ok = len(done) == len(prompts)
    per_req = []
    for r, share in zip(done, decode_shares(len(prompts), TRACE_BATCH, 16)):
        pre = row * (len(r.prompt) - r.reused_tokens)
        want = pre + row * TRACE_BATCH * share
        ok = ok and r.prefill_ad_ops == pre and r.ad_ops == want and \
            len(r.generated) == 16 and all(
                0 <= t < cfg.vocab_size for t in r.generated)
        per_req.append(r.ad_ops)
        log(f"  req {r.uid}: reused {r.reused_tokens} prompt tokens, ttft "
            f"{1e3 * (r.first_token_t - r.submit_t):.1f} ms, ad_ops "
            f"{r.ad_ops:.0f} (closed form {want:.0f}; prefill "
            f"{r.prefill_ad_ops:.0f}, closed form {pre}), tokens "
            f"{list(r.generated)}")
    forwards = len(calls["prefill"]) + len(calls["decode"])
    log(f"  reuse {'on' if reuse else 'off'}: served {st['requests']} "
        f"requests, {st['decode_tokens']} tokens in {wall:.2f} s: "
        f"{st['tokens_per_s']:.2f} tok/s, mean ttft "
        f"{1e3 * st['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{st['total_ad_ops']:.0f} ({row} a token row); {kname} launches "
        f"{launches} over {forwards} forwards, "
        f"{sorted(set(calls['prefill'] + calls['decode']))} each; logits "
        f"finite {calls['finite']}")
    if set(calls["prefill"] + calls["decode"]) != {GRANITE_LAUNCHES} or \
            launches != GRANITE_LAUNCHES * forwards:
        raise AssertionError(f"granite: {kname} launches per forward off "
                             f"{GRANITE_LAUNCHES}")
    reused = sorted(r.reused_tokens for r in done)
    if reused != ([0] + [48] * 7 if reuse else [0] * 8):
        raise AssertionError(f"granite: reused prompt tokens {reused} with "
                             f"reuse {'on' if reuse else 'off'}")
    if not ok or not calls["finite"]:
        raise AssertionError("granite: A/D ops per request off the closed "
                             "form, tokens missing or logits not finite")
    return dict(tokens_per_s=st["tokens_per_s"],
                mean_ttft_ms=1e3 * st["mean_ttft_s"],
                total_ad_ops=st["total_ad_ops"], ad_ops_per_request=per_req,
                forwards=forwards, launches=launches, wall_s=wall,
                tokens=[list(r.generated) for r in done])


def router_check(torch, rt, device: str = "cuda", depth: int = 0) -> dict:
    """The MoE of the layer at ``depth`` as compiled (bf16) on the card
    against the same layer cast to f64, on the card (made leaf by leaf, so
    no second bf16 copy is held on the way), at a batch-4 decode step (4
    groups of one token) and a batch-4 64-token prefill (4 groups of 64):
    seeded N(0, 1) inputs rounded to bf16, the layer's input dtype.  The
    two runs pick the same experts for every token whose k-th and
    (k+1)-th f64 probabilities differ by more than ``ROUTER_MARGIN`` (f32
    router logits against f64 ones differ by about 1e-7; TF32 or another
    reduced precision would move them by about 1e-3), and the outputs lie
    within ``ROUTER_REL_BAR`` in relative L2 (bf16 activations between the
    expert products: a few roundings of 2^-9 each)."""
    from repro_torch.models import moe
    cfg = rt.cfg
    layer = rt.model.layers[depth].moe
    ref = moe.MoE(cfg, torch.float64, device="meta")
    ref.load_state_dict({k: v.double() for k, v in
                         layer.state_dict().items()}, assign=True)
    k = cfg.experts_per_token
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    for label, s in (("decode", 1), ("prefill", 64)):
        x = torch.randn(TRACE_BATCH, s, cfg.d_model, generator=gen,
                        device=device).bfloat16()
        with torch.no_grad():
            y, _ = layer(x)
            y64, _ = ref(x.double())
            group = min(cfg.moe_group_size, s)
            xg = x.reshape(-1, group, cfg.d_model)
            _, _, idx = moe.route(xg, layer.router.w, k)
            p64, _, idx64 = moe.route(xg.double(), ref.router.w, k)
        top = p64.sort(-1, descending=True).values
        clear = (top[..., k - 1] - top[..., k]) > ROUTER_MARGIN
        same = (idx.sort(-1).values == idx64.sort(-1).values).all(-1)
        rel = rel_l2(y.double(), y64)
        out[label] = dict(tokens=int(clear.numel()),
                          clear_tokens=int(clear.sum()),
                          same_experts=int((same & clear).sum()),
                          same_experts_all=int(same.sum()), rel_l2=rel,
                          finite=bool(torch.isfinite(y).all()))
        log(f"  router, {label} {tuple(x.shape)}: the same experts as f64 "
            f"for {int((same & clear).sum())} of {int(clear.sum())} tokens "
            f"past the {ROUTER_MARGIN:.0e} margin ({int(same.sum())} of "
            f"{clear.numel()} in all); output relative L2 to f64 "
            f"{rel:.3e} (bar {ROUTER_REL_BAR:.0e})")
        if not bool(same[clear].all()) or rel > ROUTER_REL_BAR or \
                not out[label]["finite"]:
            raise AssertionError(f"{cfg.name}: the MoE layer on the card "
                                 f"disagrees with f64 ({label})")
    del ref
    return out


def granite_phase(torch, rec1: dict, rec3: dict, cfg,
                  device: str = "cuda") -> dict:
    """granite-moe-3b-a800m at ``cfg`` on ``pallas`` through K1, then on
    ``bit_exact`` through K3 (see the module docstring, phase 13)."""
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.xbar_mvm import kernel as k3

    torch.cuda.reset_peak_memory_stats()
    rt, gib = compile_pallas(torch, cfg, device)
    n_params = sum(t.numel() for t in rt.model.state_dict().values())
    row = planned_conversions(rt.model)
    log(f"  {n_params / 1e9:.3f} B parameters; {len(rt.plan)} planned "
        f"projections, {row} conversions a token row ({7 * row} A/D ops on "
        f"pallas)")
    if len(rt.plan) != GRANITE_LAUNCHES or 7 * row != GRANITE_ROW:
        raise AssertionError(f"granite: {len(rt.plan)} layer plans and "
                             f"{7 * row} ops a row, not {GRANITE_LAUNCHES} "
                             f"and {GRANITE_ROW}")
    prompt = trace_prompts(cfg)[0]
    out = dict(params=n_params, gib_after_compile=gib)
    runs = {}
    for backend, counter, kname, slices in (("pallas", k1, "K1", 1),
                                            ("bit_exact", k3, "K3",
                                             SLICES)):
        if backend == "bit_exact":
            t0 = time.perf_counter()
            rt = rt.with_overrides(backend="bit_exact")
            torch.cuda.synchronize()
            log(f"  programmed {len(rt.plan)} bit_exact layer plans in "
                f"{time.perf_counter() - t0:.1f} s; "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
                f"allocated")
            warm(rt)
        run = runs[backend] = {
            f"reuse_{'on' if reuse else 'off'}": granite_trace(
                torch, rt, counter, kname, slices, reuse)
            for reuse in (True, False)}
        run["launches"] = sum(r["launches"] for r in run.values())
        run.update(forward_times(torch, rt, prompt))
        log(f"  {backend}: one decode step (batch {TRACE_BATCH}) "
            f"{run['decode_step_ms']:.1f} ms, one 64-token prefill "
            f"{run['prefill64_ms']:.1f} ms")
        run["profile"] = profile_forwards(torch, rt, prompt)
        if backend == "pallas":
            log("  a full-width prefill, fake_quant against pallas (the "
                "phase-4 bar)")
            out.update(fake_quant_check(torch, rt, prompt, 256))
            out["router"] = router_check(torch, rt, device)
        else:
            run.update(plain_k3_check(torch, rt, prompt, 256))
    for rec, backend in ((rec1, "pallas"), (rec3, "bit_exact")):
        rec["launches_by_path"][GRANITE_ARCH] = runs[backend]["launches"]
    out.update(runs)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


# ---------------------------------------------------------------------------
# phase 14: full-width jamba-v0.1-52b, two of its four periods
# ---------------------------------------------------------------------------

def jamba_conversions(cfg):
    """(conversions of a token row through every projection and the
    ``lm_head``, of a prefill row that stops before the ``lm_head``): N x
    ceil(K/128) per projection, from the config."""
    def g(k):
        return -(-k // 128)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    di, ds = cfg.ssm_expand * d, cfg.ssm_d_state
    per = {"mamba": 2 * di * g(d) + (max(d // 16, 1) + 2 * ds) * g(di)
           + d * g(di),
           "attn": (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * g(d)
           + d * g(cfg.n_heads * hd),
           "mlp": 2 * f * g(d) + d * g(f), "moe": 0}
    prefill = sum(per[mixer] + per[ffn] for mixer, ffn in (
        cfg.layer_kind(i % cfg.period) for i in range(cfg.n_layers)))
    return prefill + cfg.vocab_size * g(d), prefill


def jamba_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(JAMBA_ARCH).replace(n_layers=JAMBA_LAYERS,
                                         param_dtype="bfloat16",
                                         pim_backend="pallas", remat="none")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.ssm_expand * cfg.d_model, cfg.ssm_d_state, cfg.ssm_d_conv,
            cfg.d_ff, cfg.n_experts, cfg.experts_per_token, cfg.vocab_size,
            cfg.tie_embeddings, cfg.ssm_chunk) == (
                4096, 32, 8, 128, 8192, 16, 4, 14336, 16, 2, 65536, False,
                256)
    assert jamba_conversions(cfg) == (JAMBA_ROW, JAMBA_PREFILL_ROW)
    return cfg


def jamba_trace(torch, rt, counter, kname: str, slices: int) -> dict:
    """Phase 3's trace (:func:`trace_prompts`: 8 requests, a shared
    48-token prefix plus a 16-token tail, 16 new tokens, max batch 4,
    pages of 16, greedy) through the paged engine asked for prefix reuse,
    with ``counter.LAUNCHES`` set to 0 just before and read just after.
    Fails unless the engine kept reuse off and reused no token, every
    forward (prefill and decode step) launched the kernel once per
    planned projection (``len(rt.plan)``), every logit was finite, every
    request's A/D ops equal the closed form (7 ops a conversion,
    ``slices`` conversions per group and output; the bucket's rows, pads
    included, through every projection but the ``lm_head``, the last row
    through it, and the request's share of each decode step's
    ``TRACE_BATCH`` rows), every request got 16 in-vocab tokens, and only
    the attention layers held pages (the mamba layers' ``h`` and ``conv``
    stay in the slots)."""
    from repro_torch.serve import ServeEngine
    cfg = rt.cfg
    eng = ServeEngine(rt, max_batch=TRACE_BATCH, max_len=256,
                      block_size=16, prefix_reuse=True)
    kinds = [cfg.layer_kind(i % cfg.period)[0] for i in range(cfg.n_layers)]
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    paged_ok = (not eng.prefix_reuse and eng.kv.specs == ("k", "v")
                and all(p.shape[1] == n_attn for p in eng.kv.pools.values())
                and sorted(eng.state_cache) == ["conv", "h", "len"]
                and eng.state_cache["h"].shape[0] == n_mamba
                and eng.state_cache["conv"].shape[0] == n_mamba)
    prompts = trace_prompts(cfg)
    with launches_per_call(torch, rt, counter) as calls:
        counter.LAUNCHES = 0
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        done = sorted(eng.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counter.LAUNCHES
    st = eng.stats()
    per_conv = 7 * slices
    row, prefill_row = jamba_conversions(cfg)
    ok = len(done) == len(prompts)
    per_req = []
    for r, share in zip(done, decode_shares(len(prompts), TRACE_BATCH, 16)):
        pre = per_conv * (prefill_row * bucket(len(r.prompt), 256)
                          + row - prefill_row)
        want = pre + per_conv * row * TRACE_BATCH * share
        ok = ok and r.prefill_ad_ops == pre and r.ad_ops == want and \
            len(r.generated) == 16 and all(
                0 <= t < cfg.vocab_size for t in r.generated)
        per_req.append(r.ad_ops)
        log(f"  req {r.uid}: reused {r.reused_tokens} prompt tokens, ttft "
            f"{1e3 * (r.first_token_t - r.submit_t):.1f} ms, ad_ops "
            f"{r.ad_ops:.0f} (closed form {want:.0f}; prefill "
            f"{r.prefill_ad_ops:.0f}, closed form {pre}), tokens "
            f"{list(r.generated)}")
    forwards = len(calls["prefill"]) + len(calls["decode"])
    pages = -(-(bucket(len(prompts[0]), 256) + 15) // 16)
    peak = st["paged"]["peak_pages_in_use"]
    log(f"  served {st['requests']} requests, {st['decode_tokens']} tokens "
        f"in {wall:.2f} s: {st['tokens_per_s']:.2f} tok/s, mean ttft "
        f"{1e3 * st['mean_ttft_s']:.1f} ms, total ad_ops "
        f"{st['total_ad_ops']:.0f} ({row} conversions a token row); "
        f"{kname} launches {launches} over {forwards} forwards, "
        f"{sorted(set(calls['prefill'] + calls['decode']))} each "
        f"({len(rt.plan)} planned projections); reused prompt tokens "
        f"{st['reused_prompt_tokens']} (reuse asked for, kept "
        f"{'on' if eng.prefix_reuse else 'off'}); pools hold {n_attn} "
        f"attention layers, slots {n_mamba} mamba layers' h and conv; peak "
        f"pages {peak} ({TRACE_BATCH} x {pages} expected); logits finite "
        f"{calls['finite']}")
    if set(calls["prefill"] + calls["decode"]) != {len(rt.plan)} or \
            launches != len(rt.plan) * forwards:
        raise AssertionError(f"jamba: {kname} launches per forward off "
                             f"{len(rt.plan)}")
    if not paged_ok or st["reused_prompt_tokens"] != 0 or \
            peak != TRACE_BATCH * pages:
        raise AssertionError("jamba: reuse served tokens, or pages held "
                             "other than the attention layers' rows")
    if not ok or not calls["finite"]:
        raise AssertionError("jamba: A/D ops per request off the closed "
                             "form, tokens missing or logits not finite")
    return dict(tokens_per_s=st["tokens_per_s"],
                mean_ttft_ms=1e3 * st["mean_ttft_s"],
                total_ad_ops=st["total_ad_ops"], ad_ops_per_request=per_req,
                forwards=forwards, launches=launches, wall_s=wall,
                peak_pages=peak, tokens=[list(r.generated) for r in done])


def ssm_check(torch, rt, device: str = "cuda") -> dict:
    """The chunked selective scan is the per-token step: at the model's
    widths (B = 1, d_inner, d_state) over ``JAMBA_SCAN_LEN`` tokens (four
    chunks of ``ssm_chunk`` carrying h) on seeded f32 inputs (delta a
    softplus around the init's dt range, x, B and C standard normal, A
    from layer 0's ``a_log``), from a zero and a warm h; and layer 0's
    mixer on the ``exact`` datapath in f32: one 64-token prefill against
    64 single-token steps from the zero cache.  Relative L2 of the
    outputs, the final ``h`` and ``conv`` within ``WKV_TOL``."""
    from repro_torch.models import mamba
    from repro_torch.models.layers import PimContext
    cfg = rt.cfg
    mix = rt.model.layers[0].mamba
    di, ds = mamba.d_inner(cfg), cfg.ssm_d_state
    s = JAMBA_SCAN_LEN
    gen = torch.Generator(device=device).manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    delta = mamba.softplus(randn(1, s, di) - 3.0)
    xc, b_, c_ = randn(1, s, di), randn(1, s, ds), randn(1, s, ds)
    a_neg = torch.exp(mix.a_log)
    errs = {}
    for label, h0 in (("zero", torch.zeros(1, di, ds, device=device)),
                      ("warm", randn(1, di, ds))):
        y, h_end = mamba.ssm_scan(delta, xc, b_, c_, a_neg, h0,
                                  cfg.ssm_chunk)
        h, ys = h0, []
        for t in range(s):
            y1, h = mamba.ssm_step(delta[:, t], xc[:, t], b_[:, t],
                                   c_[:, t], a_neg, h)
            ys.append(y1)
        errs[f"scan_{label}_out"] = rel_l2(y, torch.cat(ys, 1))
        errs[f"scan_{label}_h"] = rel_l2(h_end, h)
    del delta, xc, y, ys

    ctx = PimContext(cfg.replace(dtype="float32"), "exact", device=device)
    x = randn(1, 64, cfg.d_model)
    zero = {"h": torch.zeros(1, di, ds, device=device),
            "conv": torch.zeros(1, cfg.ssm_d_conv - 1, di, device=device)}
    with torch.no_grad():
        y, c_pre = mix(x, ctx, cache=zero)
        c, ys = zero, []
        for t in range(x.shape[1]):
            y1, c = mix(x[:, t:t + 1], ctx, cache=c)
            ys.append(y1)
    errs["mix_out"] = rel_l2(y, torch.cat(ys, 1))
    errs["mix_h"] = rel_l2(c_pre["h"], c["h"])
    errs["mix_conv"] = rel_l2(c_pre["conv"], c["conv"])
    log(f"  chunked scan against the step ({s} tokens, d_inner {di}, "
        f"d_state {ds}, chunk {cfg.ssm_chunk}) and layer 0's mixer (64 "
        f"tokens, exact, f32): relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bar {WKV_TOL:.0e})")
    if max(errs.values()) > WKV_TOL:
        raise AssertionError("jamba: the chunked scan and the step "
                             "disagree")
    return errs


def jamba_phase(torch, rec1: dict, rec3: dict, cfg,
                device: str = "cuda") -> dict:
    """jamba-v0.1-52b at ``cfg`` on ``pallas`` through K1, then on
    ``bit_exact`` through K3 (see the module docstring, phase 14)."""
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.xbar_mvm import kernel as k3

    torch.cuda.reset_peak_memory_stats()
    rt, gib = compile_pallas(torch, cfg, device)
    n_params = sum(t.numel() for t in rt.model.state_dict().values())
    row = planned_conversions(rt.model)
    log(f"  cut: {cfg.n_layers} of 32 layers ({cfg.n_layers // cfg.period} "
        f"of the 4 periods), every width as published; "
        f"{n_params / 1e9:.3f} B parameters, {gib:.2f} GiB after compile; "
        f"{len(rt.plan)} planned projections, {row} conversions a token "
        f"row ({7 * row} A/D ops on pallas)")
    if len(rt.plan) != JAMBA_LAUNCHES or \
            row != jamba_conversions(cfg)[0]:
        raise AssertionError(f"jamba: {len(rt.plan)} layer plans and {row} "
                             f"conversions a row, not {JAMBA_LAUNCHES} and "
                             f"{jamba_conversions(cfg)[0]}")
    prompt = trace_prompts(cfg)[0]
    out = dict(n_layers=cfg.n_layers, params=n_params,
               gib_after_compile=gib)
    out["scan"] = ssm_check(torch, rt, device)
    out["router"] = router_check(torch, rt, device, depth=1)
    runs = {}
    for backend, counter, kname, slices in (("pallas", k1, "K1", 1),
                                            ("bit_exact", k3, "K3",
                                             SLICES)):
        if backend == "bit_exact":
            t0 = time.perf_counter()
            rt = rt.with_overrides(backend="bit_exact")
            torch.cuda.synchronize()
            log(f"  programmed {len(rt.plan)} bit_exact layer plans in "
                f"{time.perf_counter() - t0:.1f} s; "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
                f"allocated")
            warm(rt)
        run = runs[backend] = jamba_trace(torch, rt, counter, kname, slices)
        run.update(forward_times(torch, rt, prompt))
        log(f"  {backend}: one decode step (batch {TRACE_BATCH}) "
            f"{run['decode_step_ms']:.1f} ms, one 64-token prefill "
            f"{run['prefill64_ms']:.1f} ms")
        run["profile"] = profile_forwards(torch, rt, prompt)
        if backend == "pallas":
            log("  a full-width prefill, fake_quant against pallas (the "
                "phase-4 bar)")
            out.update(fake_quant_check(torch, rt, prompt, 256))
            log(f"  the per-depth gate reaches depth "
                f"{max(out['depth_bar'])} of {sorted(out['depth_rel_l2'])}")
        else:
            run.update(plain_k3_check(torch, rt, prompt, 256))
    for rec, backend in ((rec1, "pallas"), (rec3, "bit_exact")):
        rec["launches_by_path"][JAMBA_ARCH] = runs[backend]["launches"]
    out.update(runs)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak {out['peak_gib']:.2f} GiB allocated in the phase")
    return out


# ---------------------------------------------------------------------------
# phase 6 at the CNNs' shapes, and phase 15: the paper's evaluation
# ---------------------------------------------------------------------------

def cnn_k3_shapes(torch) -> dict:
    """``{(K, N): (eval M, [model/layer, ...])}`` of every crossbar MVM of
    LeNet-5 and ResNet-20 on one eval batch (``CNN_EVAL_BATCH`` images)."""
    from repro_torch.models.cnn import LENET5, RESNET20, pim_shapes
    out: dict = {}
    for spec in (LENET5, RESNET20):
        for name, m, k, n in pim_shapes(spec, CNN_EVAL_BATCH):
            out.setdefault((k, n), (m, []))[1].append(f"{spec.name}/{name}")
    return out


def cnn_k3_phase(torch, rec: dict, device: str = "cuda") -> None:
    """K3 against its plain version at every (K, N) of the CNNs, at M = 1,
    4 and one eval batch's M, lossless, on twin registers and on a
    ``mode="uniform"`` set: outputs, per-output ops and op totals bit for
    bit (bit-line sums are exact and the plain version sums in the
    kernel's order).  Timed at the eval M (the phase-6 timer)."""
    from repro_torch.core.trq import make_params
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.kernels.xbar_mvm import pack_scalars

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    flush = torch.empty(2 * L2_BYTES // 4, device=dev)
    sms = k3.sm_count(dev)
    for (k, n), (m_eval, layers) in sorted(cnn_k3_shapes(torch).items()):
        for m in sorted({1, 4, m_eval}):
            a_mask, w_mask = k3_operands(torch, gen, m, k, n, dev)
            sp = k3.plan(m, -(-k // 128), n, 8, 8, sms)
            for name, regs in CNN_K3_REGS:
                p = make_params(device=dev, **regs) if regs else None
                s = pack_scalars(p, dev)
                kw = dict(lossless=p is None, per_output=True)
                if p is not None:
                    kw.update(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu,
                              mode=p.mode)
                acc, ops, per = k3.xbar_mvm_cuda(a_mask, w_mask, s, **kw)
                acc_r, ops_r, per_r = plain_k3(torch, a_mask, w_mask, s,
                                               **kw)
                torch.cuda.synchronize()
                same = torch.equal(acc, acc_r) and torch.equal(per, per_r) \
                    and int(ops) == int(ops_r)
                rec["max_abs_err"] = max(rec["max_abs_err"], float(
                    (acc - acc_r).abs().max()))
                line = (f"  {m:>6}x{k:>3}x{n:>3} {sp.body}/split "
                        f"{sp.split} {name:>8}: ops {int(ops)}, out and "
                        f"per-output ops bitwise equal to plain: {same} "
                        f"({', '.join(layers)})")
                if not same or not bool(torch.isfinite(acc).all()):
                    raise AssertionError("K3 differs from its plain version "
                                         "at a CNN shape:" + line)
                if name == "lossless" and m == m_eval:
                    kw_main = dict(kw, per_output=False)
                    kern = lambda: k3.xbar_mvm_cuda(  # noqa: E731
                        a_mask, w_mask, s, **kw_main)
                    ms = device_ms(torch, kern, 20, flush)
                    per_call = call_ms(torch, kern, 20, flush)
                    plain = device_ms(torch, lambda: plain_k3(
                        torch, a_mask, w_mask, s, **kw_main), 3, flush)
                    a8, w8 = int_mm_planes(torch, a_mask, w_mask)
                    mm_ms = device_ms(torch, lambda: torch._int_mm(a8, w8),
                                      20, flush)
                    del a8, w8
                    b, by = k3_bound(m, k, n)
                    b_ops = 2 * 64 * m * k * n / B1_OPS_PER_S * 1e3
                    rec["shapes"].append(dict(
                        shape=[m, k, n], ms=ms, call_ms=per_call,
                        plain_ms=plain, bound_ms=b, bound_by=by,
                        bound_one_bit_ms=b_ops, int_mm_ms=mm_ms,
                        body=sp.body, split=sp.split, layers=layers))
                    line += (f"; {ms:.4f} ms on the device, {per_call:.4f} "
                             f"ms per call (plain {plain:.4f} ms, bound "
                             f"{b:.4f} ms by {by}, one-bit operations "
                             f"{b_ops:.4f} ms; torch._int_mm on the 0/1 "
                             f"planes {mm_ms:.4f} ms)")
                log(line)
                del acc, acc_r, per, per_r
            del a_mask, w_mask
            torch.cuda.empty_cache()


def cnn_checks(torch, models, n_max: int, device: str) -> dict:
    """Outside the counted path: plain scoring picks the kernel's registers
    on every layer at ``n_max``; on one eval batch every layer's K3 call
    equals its plain version (out and ops), lossless and calibrated, with
    each layer's largest |acc| and its share of sums at or above 2^24."""
    from benchmarks.common_torch import trained_cnn
    from benchmarks.fig6_accuracy_torch import collect_bl
    from repro_torch.core.calibrate import _subsample, calibrate_layer
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.models.cnn import pim_forward
    from repro_torch.pim import mapping

    out = {}
    for model in models:
        spec, _, q, (x_test, _) = trained_cnn(model, device=device)
        kept = {n: _subsample(y)
                for n, y in collect_bl(q, x_test[-32:]).items()}
        cal = {n: calibrate_layer(y, n_max=n_max) for n, y in kept.items()}
        with plain_kernels():
            plain = {n: calibrate_layer(y, n_max=n_max)
                     for n, y in kept.items()}
        differ = [n for n in kept if regs(plain[n]) != regs(cal[n])]
        if differ:
            raise AssertionError(f"{model}: plain scoring picked other "
                                 f"registers on {differ}")
        log(f"  {model}: plain scoring picked identical registers on all "
            f"{len(kept)} layers at n_max = {n_max}")
        trq = {n: c.params for n, c in cal.items()}
        layers = []
        real = mapping.xbar_mvm_packed

        def checked(a_uint, w_mask, p, **kw):
            y, ops = real(a_uint, w_mask, p, **kw)
            with plain_kernels():
                y_p, ops_p = real(a_uint, w_mask, p, **kw)
            acc = (y + 128.0 * a_uint.float().sum(1, keepdim=True)).abs()
            torch.cuda.synchronize()
            layers.append(dict(
                m=a_uint.shape[0], equal=bool(torch.equal(y, y_p)) and
                int(ops) == int(ops_p), max_acc=float(acc.max()),
                above_2_24=float((acc >= 2.0 ** 24).float().mean())))
            return y, ops

        mapping.xbar_mvm_packed = cnn_mod.xbar_mvm_packed = checked
        try:
            for key, t in (("lossless", None), ("calibrated", trq)):
                layers.clear()
                pim_forward(q, x_test[:CNN_EVAL_BATCH], t)
                for name, r in zip(q.pim_layers, layers):
                    log(f"    {model}/{name} {key}: M = {r['m']}, K3 equal "
                        f"to plain {r['equal']}, largest |acc| "
                        f"{r['max_acc']:.0f}, share >= 2^24 "
                        f"{r['above_2_24']:.3g}")
                if len(layers) != len(q.pim_layers) or \
                        not all(r["equal"] for r in layers):
                    raise AssertionError(f"{model} {key}: K3 differs from "
                                         f"its plain version on an eval "
                                         f"batch")
                out[f"{model}/{key}"] = [dict(r) for r in layers]
        finally:
            mapping.xbar_mvm_packed = cnn_mod.xbar_mvm_packed = real
        torch.cuda.empty_cache()
    return out


def cnn_phase(torch, rec1: dict, rec2: dict, rec3: dict,
              device: str = "cuda") -> dict:
    """The paper's evaluation on the card (see the module docstring,
    phase 15): train, Fig. 3, Fig. 6, Fig. 6c/7, quickstart's steps 4 and
    5, with every kernel's launches counted from 0; then the checks."""
    import importlib
    import numpy as np
    from benchmarks import fig3_distribution_torch as fig3
    from benchmarks import fig6_accuracy_torch as fig6
    from benchmarks import fig6c_fig7_energy_torch as fig6c
    from benchmarks.common_torch import STEPS, cnn_loss, trained_cnn
    from repro_torch.kernels.trq_group_mvm import kernel as k1
    from repro_torch.kernels.trq_quant import kernel as k2
    from repro_torch.kernels.xbar_mvm import kernel as k3
    from repro_torch.models.cnn import LENET5, RESNET20, init_cnn, \
        pim_shapes, real_conversions
    sys.path.insert(0, os.path.join(HERE, "examples"))
    quickstart = importlib.import_module("quickstart_torch")

    dev = torch.device(device)
    torch.cuda.reset_peak_memory_stats(dev)
    stages, t = {}, time.perf_counter()

    def stage(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    # -- the main path: every count from 0 ------------------------------
    k1.LAUNCHES = k2.LAUNCHES = k2.SCORE_LAUNCHES = k3.LAUNCHES = 0
    losses = {}
    for name in ("lenet5", "resnet20"):
        spec, params, _, (x_test, y_test) = trained_cnn(name, retrain=True,
                                                        device=dev)
        stage(f"train {name} ({STEPS[name]} steps)")
        with torch.no_grad():
            losses[name] = [float(cnn_loss(p, x_test[:256], y_test[:256],
                                           spec))
                            for p in (init_cnn(spec, device=dev), params)]
        log(f"  {name}: loss on 256 test images {losses[name][0]:.4f} at "
            f"the seeded init, {losses[name][1]:.4f} trained (chance: ln 10 "
            f"= 2.3026)")
    fig3.run(device=dev)
    stage("fig3 lenet5")
    f6 = {"lenet5": fig6.run(model="lenet5", device=dev)}
    stage("fig6 lenet5")
    f6["resnet20"] = fig6.run(model="resnet20", device=dev)
    stage("fig6 resnet20")
    f6c = fig6c.run(device=dev)
    stage("fig6c/fig7")
    rng = np.random.default_rng(0)
    y = quickstart.skewed_samples(rng)
    p = quickstart.calibrate(y, dev).params
    quickstart.kernel_check(*quickstart.quantize(y, p, dev), p)
    sweep = quickstart.backend_sweep(p, rng, dev)
    stage("quickstart steps 4-5")
    launches = dict(xbar_mvm=k3.LAUNCHES, trq_score=k2.SCORE_LAUNCHES,
                    trq_quant=k2.LAUNCHES, trq_group_mvm=k1.LAUNCHES)

    # one scoring launch a calibrate_layer: Fig. 6 at each of its 7 bit
    # widths on each model's layers, Fig. 6c at n_max = 4, quickstart's
    # step 2.  One K3 launch a layer of each pim_forward: Fig. 3's
    # collect_bl (LeNet-5); Fig. 6's collect_bl, then its 512 images in
    # batches of 256 lossless and under U and TRQ at each bit width;
    # Fig. 6c's collect_bl, TRQ and lossless forwards; and two in the
    # sweep (bit_exact, and noisy, whose null model routes to bit_exact)
    n_layers = {spec.name: len(pim_shapes(spec)) for spec in (LENET5,
                                                              RESNET20)}
    calibrations = sum(n_layers.values()) * (7 + 1) + 1
    fig6_forwards = 1 + -(-512 // 256) * (1 + 2 * 7)
    k3_launches = n_layers["lenet5"] * (1 + fig6_forwards + 3) + \
        n_layers["resnet20"] * (fig6_forwards + 3) + 2
    log(f"  launches in the phase: K3 {launches['xbar_mvm']} (one a layer "
        f"of each forward, two in the sweep: {k3_launches}), K2 scoring "
        f"{launches['trq_score']} (one a calibration: {calibrations}), K2 "
        f"elementwise {launches['trq_quant']}, K1 "
        f"{launches['trq_group_mvm']}")
    if launches["trq_score"] != calibrations or \
            launches["trq_quant"] != 1 or launches["trq_group_mvm"] != 1 \
            or launches["xbar_mvm"] != k3_launches:
        raise AssertionError(f"phase 15's launches are not the path's: "
                             f"{launches}")
    rec3["launches_by_path"]["cnn"] = launches["xbar_mvm"]
    rec1["launches_by_path"]["quickstart"] = launches["trq_group_mvm"]
    for entry in ("trq_score", "trq_quant"):
        rec2["launches_by_entry"][entry] += launches[entry]
    rec2["launches"] = sum(rec2["launches_by_entry"].values())

    # -- the closed form of the lossless op total --------------------------
    for spec in (LENET5, RESNET20):
        r = f6c[spec.name]
        want = r["n_img"] * 8 * real_conversions(spec)
        log(f"  {spec.name}: lossless A/D ops {r['ops_full']} over "
            f"{r['n_img']} images, closed form {want} "
            f"({8 * real_conversions(spec)} an image); TRQ {r['ops_trq']}: "
            f"ratio {r['op_ratio']:.4f}, {1 / r['op_ratio']:.3f}x fewer "
            f"(paper: 1.6-2.3x)")
        if r["ops_full"] != want:
            raise AssertionError(f"{spec.name}: lossless A/D ops "
                                 f"{r['ops_full']} != closed form {want}")
    for model, r in f6.items():
        log(f"  {model}: float {r['float_acc']:.4f}, lossless PIM "
            f"{r['pim_lossless_acc']:.4f}; U / TRQ by bits: " + ", ".join(
                f"{b}: {r['uniform'][b]:.4f} / {r['trq'][b]:.4f}"
                for b in r["trq"]))
    stage("closed form")
    checks = cnn_checks(torch, ("lenet5", "resnet20"), 4, device)
    stage("checks")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  phase 15 stages (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()) +
        f"; peak {peak:.2f} GiB allocated")
    timed = [x for x in rec3["shapes"] if "layers" in x]
    for x in timed:
        log(f"  K3 at {'x'.join(map(str, x['shape']))} "
            f"({', '.join(x['layers'])}): {x['ms']:.4f} ms on the device, "
            f"bytes bound {k3_bound(*x['shape'])[0]:.4f} ms, one-bit "
            f"bound {x['bound_one_bit_ms']:.4f} ms")
    return dict(losses=losses, fig6=f6, fig6c=f6c, sweep=sweep, launches=launches,
                calibrations=calibrations, stages_s=stages, peak_gib=peak,
                checks=checks)


def pallas_config():
    from repro_torch.models.registry import get_config
    cfg = get_config(ARCH).replace(param_dtype="bfloat16",
                                   pim_backend="pallas", remat="none")
    assert cfg.n_layers == N_LAYERS and cfg.d_model == 3072
    return cfg


def main(argv) -> int:
    t_start = time.perf_counter()
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
               launches=0, launches_by_path={}, max_abs_err=0.0, flips=0,
               elements=0, shapes=[])
    rec2 = dict(name="trq_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/trq_quant.cu",
                replaces="src/repro/kernels/trq_quant/kernel.py:40",
                launches=0, max_abs_err=0.0, shapes=[])
    rec3 = dict(name="xbar_mvm", route="cuda",
                source="src/repro_torch/kernels/csrc/xbar_mvm.cu",
                replaces="src/repro/kernels/xbar_mvm/kernel.py:72",
                launches=0, launches_by_path={}, max_abs_err=0.0,
                shapes=[])
    log("phase 2: trq_group_mvm against its plain version")
    k1_phase(torch, rec)
    log("phase 3: serve full-width llama3.2-3b on pallas")
    cfg = pallas_config()
    serve = serve_phase(torch, rec, cfg)
    torch.cuda.empty_cache()
    log("phase 5: trq_quant against its plain version, both entries")
    k2_phase(torch, rec2)
    score = k2_score_phase(torch, rec2)
    log("phase 6: xbar_mvm against its plain version and an f64 control")
    k3_phase(torch, rec3)
    log("phase 6: xbar_mvm against its plain version at the CNNs' shapes")
    cnn_k3_phase(torch, rec3)
    log("phase 7: serve full-width llama3.2-3b on bit_exact")
    cfg_be = cfg.replace(pim_backend="bit_exact")
    serve_be = bit_exact_phase(torch, rec3, cfg_be)
    torch.cuda.empty_cache()
    log("phase 8: Algorithm 1 on the card, then serve the calibrated "
        "registers")
    qs, calib = calibrate_phase(torch, rec2, cfg_be)
    torch.cuda.empty_cache()
    log("phase 9: the serve bench on full-width llama3.2-3b, pallas and "
        "bit_exact; mixed_archs with rwkv6-7b and whisper-medium")
    bench = serve_bench_phase(torch, cfg, qs)
    torch.cuda.empty_cache()
    log("phase 10: the noise seam")
    noise = noise_phase(torch, cfg_be)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11: serve full-width {RWKV_ARCH} on pallas and bit_exact "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated)")
    t11 = time.perf_counter()
    rwkv = rwkv6_phase(torch, rec, rec3, rwkv_config())
    rwkv["phase_s"] = time.perf_counter() - t11
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12: serve full-width {WHISPER_ARCH} on pallas and "
        f"bit_exact ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"still allocated)")
    t12 = time.perf_counter()
    whisper = whisper_phase(torch, rec, rec3, whisper_config())
    whisper["phase_s"] = time.perf_counter() - t12
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13: serve full-width {GRANITE_ARCH} on pallas and "
        f"bit_exact ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"still allocated)")
    t13 = time.perf_counter()
    granite = granite_phase(torch, rec, rec3, granite_config())
    granite["phase_s"] = time.perf_counter() - t13
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14: serve full-width {JAMBA_ARCH} ({JAMBA_LAYERS} layers) "
        f"on pallas and bit_exact "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated)")
    t14 = time.perf_counter()
    jamba = jamba_phase(torch, rec, rec3, jamba_config())
    jamba["phase_s"] = time.perf_counter() - t14
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15: the paper's evaluation: LeNet-5 and ResNet-20 trained, "
        f"Figs. 3, 6, 6c and 7, quickstart's steps 4 and 5 "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated)")
    t15 = time.perf_counter()
    cnn = cnn_phase(torch, rec, rec2, rec3)
    cnn["phase_s"] = time.perf_counter() - t15
    for r in (rec, rec3):
        r["launches"] = sum(r["launches_by_path"].values())

    # K2's headline is the entry its main path launches, the scoring one
    elementwise = next(x for x in rec2["shapes"]
                       if x["shape"] == [CALIB_SAMPLES])
    by_entry = rec2.pop("launches_by_entry")
    rec2["entries"] = dict(
        trq_score=dict(score, launches=by_entry["trq_score"]),
        trq_quant=dict(elementwise, launches=by_entry["trq_quant"]))
    for r, head in ((rec, next(x for x in rec["shapes"] if tuple(
            x["shape"]) == HEADLINE_SHAPE)), (rec2, score),
                    (rec3, next(x for x in rec3["shapes"] if tuple(
                        x["shape"]) == HEADLINE_SHAPE))):
        r.update(shape=head["shape"], ms=head["ms"],
                 plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                 bound_by=head["bound_by"], library_ms=None)
    log(json.dumps({"serve": serve}))
    log(json.dumps({"serve_bit_exact": serve_be}))
    log(json.dumps({"calibration": calib}))
    log(json.dumps({"serve_bench": bench}))
    log(json.dumps({"noise": noise}))
    log(json.dumps({"rwkv6": rwkv}))
    log(json.dumps({"whisper": whisper}))
    log(json.dumps({"granite": granite}))
    log(json.dumps({"jamba": jamba}))
    log(json.dumps({"cnn": cnn}))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": [rec, rec2, rec3]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

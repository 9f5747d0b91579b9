"""Readings behind the decode layout's card checks (``chip_smoke.py``
phase 19): whether a decode step on a rank's share of the attention heads
is bitwise the whole call's, what the decode_attn kernel costs a decode
step against the batched einsum it replaced, and how the head-dim
branch's whole-model trace agrees with the mesh-less one.  Needs a card:

  PYTHONPATH=src python tools/decode_heads.py [--part PART ...]

* ``bitwise``: ``decode_attention`` and ``cross_decode_attention`` on
  1/m of the KV heads against those heads of the whole call, m = 2, 4, 8,
  at the decode shapes of llama, whisper, deepseek and glm4, on the
  batched einsum (the kernel's plain version, run on the card) and on the
  port's route (``kernels.decode_attn``).
* ``cost``: a batch-4 decode step of full-width llama3.2-3b (28 layers)
  and of the whisper-medium engine (24 + 24 layers, 1,500 frames) on
  ``pallas``, with each route, interleaved: three rounds of the median
  of 5 (llama) or of one engine step each (whisper).
* ``head-dim``: glm4-9b at 2 layers on four threaded ranks (phase 19's
  head-dim part) on trace seeds 0-9 at 4 requests x 4 tokens and 0-1 at
  8 x 16.
* ``first-gap``: the same model under ``'tp'`` (every prefill whole on
  each rank, as the reference's decode cells run), 8 x 16 of seed 0: the
  first call whose logits or attention output (``wo``'s input) leaves
  the mesh-less run's.

Every part runs whatever an earlier one raised; the exit code is 1 when
any part failed, and the failed parts are named on the last line.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4, 8, 3, 128, 256), (2, 8, 3, 128, 256), (4, 16, 1, 64, 1504),
          (4, 16, 1, 64, 256), (4, 32, 1, 128, 256), (4, 8, 8, 128, 32768),
          (4, 2, 16, 128, 256), (4, 8, 3, 128, 4096))


ROUTES = ("batched einsum", "decode_attn kernel")


def set_route(attention, name: str) -> None:
    """Send the model's one-row attention through the kernel's plain
    versions (the batched einsum, on the card) or the kernel."""
    from repro_torch.kernels.decode_attn import ops, ref
    plain = name == ROUTES[0]
    attention.attn_scores = ref.attn_scores_ref if plain else \
        ops.attn_scores
    attention.attn_values = ref.attn_values_ref if plain else \
        ops.attn_values


def bitwise(torch, attention, log) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in ROUTES:
        set_route(attention, name)
        cases = off = 0
        for b, kv, g, hd, s in SHAPES:
            q = torch.randn(b, 1, kv, g, hd, generator=gen, device="cuda")
            kc, vc = (torch.randn(b, s, kv, hd, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            n = torch.full((b,), s - 3, dtype=torch.int32, device="cuda")
            whole = attention.decode_attention(q, kc, vc, n)
            wx = attention.cross_decode_attention(q, kc, vc)
            for m in (2, 4, 8):
                if kv % m:
                    continue
                h, same = kv // m, True
                for i in range(m):
                    sl = slice(i * h, (i + 1) * h)
                    part = attention.decode_attention(
                        q[:, :, sl], kc[:, :, sl], vc[:, :, sl], n,
                        hd ** -0.5)
                    px = attention.cross_decode_attention(
                        q[:, :, sl], kc[:, :, sl], vc[:, :, sl],
                        hd ** -0.5)
                    same &= torch.equal(part, whole[:, :, sl]) and \
                        torch.equal(px, wx[:, :, sl])
                cases += 1
                off += not same
                if not same:
                    log(f"  {name}: (B, KV, G, hd, S) {(b, kv, g, hd, s)} "
                        f"on 1/{m} of the heads: not bitwise")
        log(f"{name}: {cases - off} of {cases} shape and share cases "
            f"bitwise")
    set_route(attention, ROUTES[1])


def cost(torch, attention, cs, log) -> None:
    from repro_torch.models.registry import get_config

    def rounds(measure) -> dict:
        out: dict = {}
        for r in range(3):
            for name in ROUTES if r % 2 == 0 else reversed(ROUTES):
                set_route(attention, name)
                out.setdefault(name, []).append(round(measure(), 2))
        set_route(attention, ROUTES[1])
        return out
    cfg = cs.pallas_config()
    rt, _ = cs.compile_pallas(torch, cfg)
    prompt = cs.trace_prompts(cfg)[0]
    llama = rounds(lambda: cs.forward_times(torch, rt, prompt)[
        "decode_step_ms"])
    log(f"llama decode step ms (batch 4): {llama}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    wcfg = get_config(cs.WHISPER_ARCH).replace(
        param_dtype="bfloat16", pim_backend="pallas", remat="none")
    rt, _ = cs.compile_pallas(torch, wcfg)
    gen = torch.Generator(device="cuda").manual_seed(12)
    frames = torch.randn(cs.WHISPER_BATCH, cs.WHISPER_FRAMES, wcfg.d_model,
                         generator=gen, device="cuda")

    def step() -> float:
        return cs.whisper_forwards(
            torch, rt, frames, lambda k, fn: cs.wall_ms(torch, fn)
            if k == "decode_step" else 0.0)["decode_step"]
    log(f"whisper ({wcfg.n_layers} + {wcfg.encoder_layers} layers) engine "
        f"decode step ms (batch 4): {rounds(step)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


def head_dim(torch, cs, log) -> None:
    rec = {"launches_by_path": {}, "entries": {
        "trq_group_mvm_psums": {"launches": 0},
        "trq_group_mvm_quantize": {"launches": 0}}}
    saved = cs.HEADS_DIM_TRACE, cs.HEADS_DIM_SEED
    try:
        for trace, seeds in (((4, 4), range(10)), ((8, 16), range(2))):
            for seed in seeds:
                cs.HEADS_DIM_TRACE, cs.HEADS_DIM_SEED = trace, seed
                try:
                    out = cs.head_dim_phase(torch, rec)
                    log(f"trace {trace} seed {seed}: equal; gap "
                        f"{out['gap']}")
                except AssertionError as e:
                    log(f"trace {trace} seed {seed}: {str(e)[:240]}")
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        cs.HEADS_DIM_TRACE, cs.HEADS_DIM_SEED = saved


def first_gap(torch, cs, log) -> None:
    from repro_torch import runtime
    from repro_torch.models.registry import init
    cfg = cs.dense_config(cs.HEADS_DIM[0], cs.HEADS_DIM[1]).replace(
        parallelism="tp")

    def recorded(rt) -> list:
        calls = []
        for name in ("prefill", "prefill_cont", "decode"):
            def wrap(*a, _fn=getattr(rt, name), _name=name, **k):
                attn = []
                hooks = [layer.attn.wo.register_forward_pre_hook(
                    lambda m, x: attn.append(x[0].detach().clone()))
                    for layer in rt.model.layers]
                (logits, cache), rep = _fn(*a, **k)
                for h in hooks:
                    h.remove()
                calls.append((_name, logits.detach().clone(), attn))
                return (logits, cache), rep
            setattr(rt, name, wrap)
        return calls
    rt = runtime.compile(cfg, init(cfg, seed=0, device="cuda"),
                         device="cuda")
    want = recorded(rt)
    cs.engine_trace(torch, rt, cfg, 0, 8, 16)
    del rt

    def rank_main(r, mesh, gate):
        rt = runtime.compile(cfg, init(cfg, seed=0, device="cuda"),
                             device="cuda", mesh=mesh)
        got = recorded(rt)
        cs.engine_trace(torch, rt, cfg, 0, 8, 16)
        return got
    got = cs.threaded_ranks(torch, cs.HEADS_DIM[2], rank_main, 600)[0]
    for i, ((name, l1, a1), (_, l2, a2)) in enumerate(zip(got, want)):
        if not torch.equal(l1, l2) or not all(
                torch.equal(x, y) for x, y in zip(a1, a2)):
            gaps = [float((x.float() - y.float()).abs().max())
                    for x, y in zip(a1, a2)]
            log(f"first call off: {i} ({name}); logits max "
                f"{float((l1 - l2).abs().max()):.3e}; attention max by "
                f"layer {gaps}")
            return
    log("every call bitwise")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    parts = ("bitwise", "cost", "head-dim", "first-gap")
    ap.add_argument("--part", choices=parts, action="append")
    args = ap.parse_args(argv)
    parts = args.part or parts
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("decode_heads: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import attention
    cs.import_port()
    cs.log(cs.card_line())
    build.build(build.KERNELS)
    failed = []
    for part in parts:
        t0 = time.perf_counter()
        cs.log(f"[{part}]")
        try:
            if part == "bitwise":
                bitwise(torch, attention, cs.log)
            elif part == "cost":
                cost(torch, attention, cs, cs.log)
            elif part == "head-dim":
                head_dim(torch, cs, cs.log)
            else:
                first_gap(torch, cs, cs.log)
        except Exception:                     # the other parts still run
            failed.append(part)
            cs.log(traceback.format_exc())
        gc.collect()
        torch.cuda.empty_cache()
        cs.log(f"[{part}] {time.perf_counter() - t0:.1f} s")
    cs.log(f"failed parts: {failed}" if failed else "every part ran")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

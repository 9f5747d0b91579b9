"""Batched serving CLI on the GPU (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 8 --max-new 16 --shared-prefix 48 --prompt-len 16

Serves randomly initialised (seeded) weights at the arch's full width on
``--device`` (default ``cuda``; ``--smoke --device cpu`` runs the reduced
config with the kernels' plain versions).  With ``--pim pallas`` every
projection runs the ``trq_group_mvm`` CUDA kernel; with ``--pim bit_exact``
the bit-exact sliced crossbar, one A/D conversion per bit-line, through the
``xbar_mvm`` CUDA kernel; ``--pim noisy`` is ``bit_exact`` under the
ideal ``CrossbarModel``, so it runs the same kernel.  ``--quant-state``
installs Algorithm-1 per-layer registers; without it every layer takes the
model-wide default (which ``pallas`` auto-ranges).  ``--energy-report``
prints the per-request A/D-conversion and energy table.  An
encoder-decoder (``--arch whisper-medium``) gets 8 zero frames per prompt
as its encoder input, and a patch frontend (``--arch internvl2-76b``) 8
zero patch embeddings as its sequence prefix, as the reference launcher
feeds them.  The run is on the host mesh (``launch.mesh.make_host_mesh``:
``(1, 1)`` on one card, ``(n, 1)`` over the ranks of a process group): on
more than one rank every parameter and the page pools are DTensors on it;
on one rank nothing is placed (the same numbers, without the hooks).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import runtime
from ..core.quant_state import load_quant_state
from ..models.registry import ARCHS, get_config, init
from ..pim.backend import list_backends
from ..serve.engine import ServeEngine
from ..telemetry.serve_report import format_energy_report, serve_report
from .mesh import host_mesh, sharding_mesh


def frames_stub(cfg, n_frames: int = 8):
    """The engine's ``extra_inputs`` for ``cfg``: ``n_frames`` zero
    embeddings at every prefill of an encoder-decoder or a patch frontend
    (the stub frontends), nothing otherwise."""
    import torch

    def extra_inputs(b: int, s: int) -> dict:
        if (cfg.encoder_layers > 0 or cfg.frontend == "patch") and s > 1:
            return {"embeds": torch.zeros((b, n_frames, cfg.d_model))}
        return {}
    return extra_inputs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend the same N-token system prompt to every "
                         "request (exercises prefix reuse)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--pim", default="fake_quant",
                    choices=sorted(list_backends()),
                    help="PIM execution backend")
    ap.add_argument("--backend", default=None,
                    help="late backend override applied with "
                         "rt.with_overrides after compiling")
    ap.add_argument("--quant-state", default=None,
                    help="Algorithm-1 per-layer registers "
                         "(quant_state.json or its checkpoint dir)")
    ap.add_argument("--plan", action=argparse.BooleanOptionalAction,
                    default=True, help="weight-stationary plan cache")
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=True, help="paged KV cache (block pool)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-reuse", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--energy-report", action="store_true",
                    help="print the per-request A/D-energy table")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with host_mesh(args.device) as mesh:
        return _serve(args, mesh)


def _serve(args, mesh) -> int:
    cfg = get_config(args.arch, smoke=args.smoke).replace(
        pim_backend=args.pim, param_dtype="bfloat16", remat="none")
    qs = None
    if args.quant_state:
        qs = load_quant_state(args.quant_state)
        print(f"loaded {len(qs)} per-layer SAR register rules")
    device = runtime.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    print(f"arch={cfg.name} pim={cfg.pim_backend} device={device} "
          f"max_batch={args.max_batch} max_len={args.max_len} "
          f"paged={args.paged} block_size={args.block_size} "
          f"prefix_reuse={args.prefix_reuse}")

    state = init(cfg, seed=args.seed, device=device)
    print(f"mesh={tuple(mesh.shape)}")
    rt = runtime.compile(cfg, state, device=device, quant_state=qs,
                         plan=args.plan if not args.backend else None,
                         mesh=sharding_mesh(mesh))
    if args.backend:
        rt = rt.with_overrides(backend=args.backend, plan=args.plan)
        print(f"backend override: serving on {rt.backend!r}")
    engine = ServeEngine(rt, max_batch=args.max_batch, max_len=args.max_len,
                         extra_inputs=frames_stub(cfg),
                         paged=args.paged, block_size=args.block_size,
                         prefix_reuse=args.prefix_reuse,
                         num_blocks=args.num_blocks, rng_seed=args.seed)
    if engine.plan is not None:
        print(f"programmed {len(engine.plan)} crossbar layer plans "
              f"({rt.backend})")
    prefix = rng.integers(0, cfg.vocab_size, args.shared_prefix) \
        if args.shared_prefix else None
    for _ in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size, args.prompt_len)
        prompt = tail if prefix is None else np.concatenate([prefix, tail])
        engine.submit(prompt, max_new_tokens=args.max_new,
                      temperature=args.temperature)
    done = engine.run()
    st = engine.stats()
    print(f"served {st['requests']} requests, {st['decode_tokens']} tokens, "
          f"{st['tokens_per_s']:.1f} tok/s, "
          f"ttft {st['mean_ttft_s'] * 1e3:.0f}ms, "
          f"{st['total_ad_ops']:.3e} A/D ops "
          f"({st['total_ad_energy_pj'] / 1e6:.3f} uJ)")
    if args.energy_report:
        print(format_energy_report(serve_report(engine)))
    for r in done[:3]:
        print(f"  req {r.uid}: {list(r.generated)[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())

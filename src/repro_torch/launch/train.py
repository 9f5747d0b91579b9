"""End-to-end training CLI on the GPU (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --device cpu --steps 50 --batch 8 --seq 256 --ckpt-dir CKPT

Trains seeded random weights (f32 masters, the config's compute dtype) of
``--arch`` on the port's synthetic ``TokenStream`` on ``--device`` (default
``cuda``).  ``--pim`` picks a differentiable datapath: ``exact``, or
``fake_quant``, quantization-aware training through the TRQ quantizer's
straight-through estimator (``pallas`` and ``bit_exact`` have no gradient
path).  Every ``--ckpt-every`` steps an asynchronous checkpoint is written
in the reference's format; ``--resume`` restarts from the newest one
(exact: the data stream is stateless).  The run is on the host mesh
(``launch.mesh.make_host_mesh``: ``(1, 1)`` on one card, ``(n, 1)`` over
the ranks of a process group): on more than one rank it goes through
``Runtime.train_setup``, the parameters and the ZeRO-1 optimizer state
DTensors on the mesh; on one rank it runs the mesh-less step, which
gives the same numbers without the placement's hooks.

Every arch whose train step is held to the reference's trains: the dense
and MoE decoders (llama3.2-3b, deepseek-7b, glm4-9b, deepseek-67b,
granite-moe-3b-a800m, arctic-480b at ``--smoke``), rwkv6-7b, the
mamba/attention hybrid jamba-v0.1-52b and the encoder-decoder
whisper-medium.  A batch carries what the reference's CLI adds: zero
``embeds`` of 8 rows for a frontend, of ``--seq`` frames for an encoder.
internvl2-76b is refused: the reference cannot train it either (see
``REFUSED``).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import runtime
from ..ckpt.checkpoint import latest_step, restore_train_state, wait_pending
from ..data.synthetic import TokenStream
from ..models.registry import ARCHS, get_config, init
from ..train.loop import Trainer
from .mesh import host_mesh, sharding_mesh
from .steps import MOE_FFN_SHARD_DATA, make_train_config

FRONTEND_ROWS = 8      # the reference CLI's zero frontend rows a sequence
# archs the reference's own train step fails on
REFUSED = {
    "internvl2-76b": (
        "the reference cannot train it either: its CLI adds 8 patch rows "
        "to every batch, its forward returns logits over F + S rows, and "
        "its loss (src/repro/train/loop.py:34-35) broadcasts them against "
        "the S labels and fails (ROADMAP.md, section 3)"),
}


def make_batch_at(cfg, stream: TokenStream, device):
    """``step -> batch``: the stream's ``tokens`` and ``labels`` with the
    zero f32 ``embeds`` the reference's CLI adds, ``(B, 8, d)`` for a
    ``patch``/``frames`` frontend, then ``(B, seq, d)`` frames for an
    encoder in their place."""
    def batch_at(step):
        b = stream.batch_at(step, device)
        rows = None
        if cfg.frontend in ("patch", "frames"):
            rows = FRONTEND_ROWS
        if cfg.encoder_layers:
            rows = stream.seq_len
        if rows is not None:
            b["embeds"] = torch.zeros((stream.batch, rows, cfg.d_model),
                                      dtype=torch.float32,
                                      device=b["tokens"].device)
        return b
    return batch_at


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--pim", default="exact", choices=runtime.TRAIN_BACKENDS,
                    help="PIM execution backend (the differentiable ones)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-json", default=None)
    args = ap.parse_args(argv)
    if args.arch in REFUSED:
        ap.error(f"--arch {args.arch} does not train: {REFUSED[args.arch]}")
    with host_mesh(args.device) as mesh:
        return _train(args, mesh)


def _train(args, mesh) -> int:

    cfg = get_config(args.arch, smoke=args.smoke).replace(
        pim_backend=args.pim)
    tc = make_train_config(args.arch, learning_rate=args.lr,
                           total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1),
                           microbatch=args.microbatch,
                           checkpoint_every=args.ckpt_every)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"device={args.device} mesh={tuple(mesh.shape)} "
          f"pim={cfg.pim_backend}")
    moe_fsdp = args.arch in MOE_FFN_SHARD_DATA
    rt = runtime.compile(cfg, init(cfg, seed=args.seed, device=args.device),
                         device=args.device, plan=None, tc=tc,
                         mesh=sharding_mesh(mesh),
                         moe_ffn_shard_data=moe_fsdp)
    if rt.mesh is None:
        opt_init = rt.opt_init

        def step(params, opt_state, batch, i):
            return rt.train_step(params, opt_state, batch, i)[0]
    else:
        step, opt_init, _, _ = rt.train_setup(moe_ffn_shard_data=moe_fsdp)
    params = rt.params
    opt_state = opt_init()
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        params, opt_state, start = restore_train_state(
            args.ckpt_dir, params, opt_state, cfg)
        print(f"resumed from step {start}")

    trainer = Trainer(
        train_step=step,
        batch_at=make_batch_at(cfg, stream, rt.device), tc=tc,
        ckpt_dir=args.ckpt_dir, cfg=cfg)
    params, opt_state, report = trainer.run(
        params, opt_state, start_step=start, num_steps=args.steps,
        on_metrics=lambda r: print(f"step {r['step']:5d} loss "
                                   f"{r['loss']:.4f} "
                                   f"({r['step_time_s']:.2f}s)", flush=True))
    wait_pending()
    if not report["history"]:
        print(f"nothing to do: the checkpoint is at step {start}")
        return 0
    print(f"median step {report['median_step_s']:.3f}s, "
          f"stragglers flagged: {len(report['stragglers'])}")
    first = report["history"][0]["loss"]
    last = report["history"][-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f}")
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

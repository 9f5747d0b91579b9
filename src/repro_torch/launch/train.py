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
(exact: the data stream is stateless).  There is no mesh: one device.

The dense and MoE decoders train (llama3.2-3b, deepseek-7b, glm4-9b,
deepseek-67b, granite-moe-3b-a800m, arctic-480b at ``--smoke``): their
train steps are held to the reference's.  rwkv6-7b, jamba-v0.1-52b,
whisper-medium and internvl2-76b are refused until theirs are.
"""
from __future__ import annotations

import argparse
import json
import sys

from .. import runtime
from ..ckpt.checkpoint import latest_step, restore_train_state, wait_pending
from ..data.synthetic import TokenStream
from ..models.registry import ARCHS, get_config, init
from ..train.loop import Trainer
from .steps import make_train_config

# archs whose train step is not yet held to the reference's (ROADMAP.md,
# queue 1, "the next training slice")
NOT_YET = {
    "rwkv6-7b": "the chunked WKV scan's train step",
    "jamba-v0.1-52b": "the mamba scan's train step",
    "whisper-medium": "the encoder-decoder's train step (frames)",
    "internvl2-76b": "the patch frontend's train step",
}


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
    if args.arch in NOT_YET:
        ap.error(f"--arch {args.arch}: {NOT_YET[args.arch]} is not held to "
                 f"the reference yet (ROADMAP.md, queue 1: the next "
                 f"training slice)")

    cfg = get_config(args.arch, smoke=args.smoke).replace(
        pim_backend=args.pim)
    tc = make_train_config(args.arch, learning_rate=args.lr,
                           total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1),
                           microbatch=args.microbatch,
                           checkpoint_every=args.ckpt_every)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"device={args.device} pim={cfg.pim_backend}")
    rt = runtime.compile(cfg, init(cfg, seed=args.seed, device=args.device),
                         device=args.device, plan=None, tc=tc)
    params = rt.params
    opt_state = rt.opt_init()
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch,
                         seed=args.seed)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir):
        params, opt_state, start = restore_train_state(
            args.ckpt_dir, params, opt_state, cfg)
        print(f"resumed from step {start}")

    trainer = Trainer(
        train_step=lambda p, o, b, i: rt.train_step(p, o, b, i)[0],
        batch_at=lambda i: stream.batch_at(i, rt.device), tc=tc,
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

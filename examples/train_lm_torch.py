"""End-to-end LM training on the GPU (port of ``examples/train_lm.py``):
a ~100M-parameter llama-class model, a few hundred steps on the port's
synthetic ``TokenStream``, checkpoints in the reference's format; the loss
must drop.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
      [--d-model 512] [--device cpu]

``--arch`` trains a registry config instead (at ``--smoke``, the reduced
one), with the batches of ``repro_torch.launch.train`` (an
encoder-decoder's zero frames):

  PYTHONPATH=src python examples/train_lm_torch.py --arch whisper-medium \
      --smoke --device cpu --steps 30 --batch 2 --seq 32
"""
import argparse
import os
import sys
import tempfile

from repro_torch import runtime
from repro_torch.ckpt.checkpoint import wait_pending
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.train import REFUSED, make_batch_at
from repro_torch.models.registry import ARCHS, get_config, init
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default=None,
                    choices=[a for a in ARCHS if a not in REFUSED],
                    help="a registry config instead of the ~100M llama")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the reduced config")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = get_config(args.arch, smoke=args.smoke)
        print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    else:
        # ~100M params: 8 layers x d512 (ffn 4x) + 4k vocab
        cfg = get_config("llama3.2-3b").replace(
            n_layers=args.layers, d_model=args.d_model, n_heads=8,
            n_kv_heads=4, d_ff=4 * args.d_model, vocab_size=args.vocab,
            remat="none", attn_chunk_q=args.seq, attn_chunk_k=args.seq)
        n_params_est = (cfg.vocab_size * cfg.d_model * 2
                        + cfg.n_layers * 3.5 * cfg.d_model * cfg.d_ff)
        print(f"model ~{n_params_est / 1e6:.0f}M params, "
              f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    tc = TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                     warmup_steps=args.steps // 10,
                     checkpoint_every=max(args.steps // 4, 1))
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm")
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)
    # the Runtime is the execution context: the model on the device, the
    # train step with per-step A/D-op metering, the optimizer state
    rt = runtime.compile(cfg, init(cfg, seed=0, device=args.device),
                         device=args.device, plan=None, tc=tc)
    trainer = Trainer(train_step=lambda p, o, b, i: rt.train_step(
        p, o, b, i)[0], batch_at=make_batch_at(cfg, stream, rt.device),
        tc=tc, ckpt_dir=ckpt_dir, log_every=10, cfg=cfg)
    _, _, report = trainer.run(
        rt.params, rt.opt_init(), num_steps=args.steps,
        on_metrics=lambda r: print(
            f"  step {r['step']:4d}  loss {r['loss']:.4f}  "
            f"lr {r['lr']:.2e}  {r['step_time_s']:.2f}s", flush=True))
    wait_pending()

    first, last = report["history"][0]["loss"], report["history"][-1]["loss"]
    print(f"\nloss: {first:.4f} -> {last:.4f} "
          f"({'OK: learning' if last < first - 0.3 else 'WARN: check lr'})")
    print(f"median step: {report['median_step_s']:.3f}s; "
          f"stragglers: {len(report['stragglers'])}; "
          f"checkpoints in {ckpt_dir}")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())

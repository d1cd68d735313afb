"""End-to-end training launcher, ported from ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--smoke] [--steps 300 --batch 8 --seq 256] [--ckpt-dir DIR] \
        [--device cpu]

``--smoke`` selects the reduced config; without it the full published
config is built (llama3.2-1b at full width and depth fits one H100).
``--device`` defaults to ``cuda`` (asking for it without CUDA raises);
there the blocks run the flash-attention / SSD-scan kernels, forward and
recomputed forward, with their gradients through the kernels'
``autograd.Function``s. Every family's ``loss_fn`` is ported (the moe
family's with its aux losses); the card runs of ``chip_smoke.py`` train
the dense family and mamba2-130m.
The reference's ``--devices`` and ``--model-parallel`` (a mesh of host
devices) wait for the distributed port (``ROADMAP.md`` B6).
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs import base as CB
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig

    cfg = CB.get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                     microbatches=args.microbatches, num_steps=args.steps,
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, seed=args.seed)
    hp = OptHParams(learning_rate=args.lr,
                    warmup_steps=max(args.steps // 10, 1),
                    decay_steps=args.steps)
    trainer = Trainer(cfg, tc, hp=hp, device=args.device)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step}", flush=True)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"on {trainer.device}", flush=True)
    final = trainer.run()
    print(f"done: step {trainer.step} loss {final['loss']:.4f}")
    if trainer.monitor.flagged:
        print(f"straggler flags: {trainer.monitor.flagged}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

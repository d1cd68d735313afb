"""End-to-end training run on the PyTorch port, the twin of
``examples/train_lm.py``: a ~20M-param llama-family model for a few
hundred steps, with checkpointing, a simulated mid-run preemption, and
automatic recovery — the full fault-tolerance loop.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \
        [--device cpu]

``--device`` defaults to ``cuda``; asking for it without a card raises.
On the card the attention of every block runs the flash-attention kernel
(its gradient through the kernel's ``autograd.Function``).
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import base as CB
from repro_torch.train.fault_tolerance import FailureInjector, \
    run_with_recovery
from repro_torch.train.optimizer import OptHParams
from repro_torch.train.trainer import Trainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--width", type=int, default=256,
                    help="d_model; 768+ reaches the ~100M-param regime")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    # llama3.2-1b family shrunk to CPU scale (--width 768 ~ 100M params)
    cfg = dataclasses.replace(
        CB.get_config("llama3.2-1b", smoke=True),
        num_layers=4, d_model=args.width, num_heads=args.width // 64,
        num_kv_heads=max(args.width // 128, 1), d_ff=3 * args.width,
        vocab_size=4096, remat=False)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model}) on {args.device}")

    ckpt_dir = tempfile.mkdtemp(prefix="torch_train_lm_ckpt_")
    injector = FailureInjector([args.steps // 2])   # preempt mid-run

    def make_trainer(attempt: int) -> Trainer:
        if attempt:
            print(f"--- restart #{attempt}: recovering from {ckpt_dir}")
        tc = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                         num_steps=args.steps, log_every=args.ckpt_every,
                         ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir)
        hp = OptHParams(learning_rate=1e-3, warmup_steps=20,
                        decay_steps=args.steps)
        return Trainer(cfg, tc, hp=hp, device=args.device)

    report = run_with_recovery(make_trainer, args.steps, injector=injector)
    print(f"\ndone: {report.completed_steps} steps, "
          f"{report.restarts} restart(s) after preemption at "
          f"{report.preemptions}, final loss "
          f"{report.final_metrics['loss']:.4f}")
    return report


if __name__ == "__main__":
    main()

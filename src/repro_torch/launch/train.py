"""End-to-end training launcher, ported from ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--smoke] [--steps 300 --batch 8 --seq 256] [--ckpt-dir DIR] \
        [--device cpu] [--devices N --model-parallel M]

``--smoke`` selects the reduced config; without it the full published
config is built (llama3.2-1b at full width and depth fits one H100).
``--device`` defaults to ``cuda`` (asking for it without CUDA raises);
there the blocks run the flash-attention / SSD-scan kernels, forward and
recomputed forward, with their gradients through the kernels'
``autograd.Function``s. Every family's ``loss_fn`` is ported (the moe
family's with its aux losses); the card runs of ``chip_smoke.py`` train
the dense family and mamba2-130m.
``--devices N`` starts N ranks (``launch.mesh.spawn``: one process each,
a ``FileStore`` in a temporary directory, ``gloo`` with ``--device cpu``,
``nccl`` with ``--device cuda``, one card per rank; more ranks than cards
raises) and trains on an (N/model_parallel, model_parallel) ``("data",
"model")`` mesh — the launcher path a pod slice uses. Rank 0 prints.
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
    ap.add_argument("--devices", type=int, default=0,
                    help="start N ranks and shard over them")
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)

    if args.devices:
        from repro_torch.launch.mesh import spawn
        if args.devices % args.model_parallel:
            raise SystemExit(f"--devices {args.devices} is not a multiple "
                             f"of --model-parallel {args.model_parallel}")
        spawn(_train, args.devices, device=args.device, args=(args,))
        return 0
    _train(0, 1, args)
    return 0


def _train(rank: int, world: int, args) -> None:
    from repro_torch.configs import base as CB
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig

    cfg = CB.get_config(args.arch, smoke=args.smoke)
    mesh = None
    if args.devices:
        from repro_torch.launch.mesh import make_mesh
        mp = args.model_parallel
        mesh = make_mesh((args.devices // mp, mp), ("data", "model"),
                         device=args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    tc = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                     microbatches=args.microbatches, num_steps=args.steps,
                     log_every=args.log_every if rank == 0 else 0,
                     ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, seed=args.seed)
    hp = OptHParams(learning_rate=args.lr,
                    warmup_steps=max(args.steps // 10, 1),
                    decay_steps=args.steps)
    trainer = Trainer(cfg, tc, hp=hp, mesh=mesh, device=args.device)
    if trainer.maybe_restore():
        say(f"resumed from step {trainer.step}", flush=True)
    where = (f"{world} ranks, mesh {tuple(mesh.shape)} ('data', 'model'), "
             f"{trainer.device.type}" if mesh is not None
             else str(trainer.device))
    say(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
        f"on {where}", flush=True)
    final = trainer.run()
    say(f"done: step {trainer.step} loss {final['loss']:.4f}")
    if trainer.monitor.flagged:
        say(f"straggler flags: {trainer.monitor.flagged}")


if __name__ == "__main__":
    sys.exit(main())

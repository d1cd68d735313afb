"""Batched LM serving driver, ported from ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --smoke --requests 8 --slots 4 --max-new 16 [--device cpu]

Ported archs: ``llama3.2-1b`` (dense) and ``mamba2-130m`` (ssm). The model
is initialised from ``--seed`` on ``--device`` (default ``cuda``; asking
for CUDA without it raises).
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import base as CB
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    cfg = CB.get_config(args.arch, smoke=args.smoke)
    model = M.init(cfg, seed=args.seed, device=args.device)
    eng = Engine(cfg, model, batch_slots=args.slots, max_len=args.max_len)
    del model

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(2, 12))
        prompt = rng.integers(1, min(cfg.vocab_size, 1000),
                              size=plen).tolist()
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run()
    for r in done[: min(4, len(done))]:
        print(f"req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    s = eng.stats
    print(f"{len(done)} requests in {s.waves} waves | "
          f"prefill {s.prefill_tokens} tok, "
          f"generated {s.generated_tokens} tok | {s.tokens_per_s:.1f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

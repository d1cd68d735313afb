"""Batched serving demo on the PyTorch port: the wave-scheduled engine on
two architecture families — a dense transformer (KV cache) and an
attention-free SSM (constant-size state, the long-context family). The
twin of ``examples/serving.py``; the models are the SMOKE configurations
with random weights from seed 0.

    PYTHONPATH=src python examples/torch_serving.py [--device cpu]

``--device`` defaults to ``cuda``; asking for it without a card raises.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import base as CB
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine


def serve(arch: str, n_requests: int = 6, slots: int = 3,
          device: str = "cuda") -> dict:
    cfg = CB.get_config(arch, smoke=True)
    model = M.init(cfg, seed=0, device=device)
    eng = Engine(cfg, model, batch_slots=slots, max_len=96)

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(n_requests):
        prompt = rng.integers(1, min(cfg.vocab_size, 200),
                              size=int(rng.integers(3, 10))).tolist()
        reqs.append(eng.submit(prompt, max_new_tokens=12))
    t0 = time.time()
    eng.run()
    dt = time.time() - t0

    s = eng.stats
    lat = [r.t_finish - r.t_submit for r in reqs]
    print(f"[{arch}] {n_requests} requests, {slots} slots -> {s.waves} waves")
    print(f"  generated {s.generated_tokens} tokens in {dt:.2f}s "
          f"({s.tokens_per_s:.1f} tok/s), "
          f"p50 latency {np.median(lat)*1e3:.0f} ms")
    print(f"  sample output: {reqs[0].output}")
    return {"arch": arch, "waves": s.waves,
            "generated_tokens": s.generated_tokens,
            "outputs": [r.output for r in reqs]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cuda or cpu)")
    args = ap.parse_args(argv)
    return [serve("llama3.2-1b", device=args.device),   # dense GQA + KV
            serve("mamba2-130m", device=args.device)]   # SSM: O(1) state


if __name__ == "__main__":
    main()

"""Latency-prediction service command line — replay a synthetic mixed workload
(measured + cross + two-phase, every trained device pair) through
``repro_torch.serve.LatencyService`` on the card and report the
wave/fusion/cache telemetry.

    PYTHONPATH=src python -m repro_torch.launch.serve_latency --full

Default is a small fast oracle (2 devices, deterministic members);
``--full`` fits the paper's 4-device grid with all three members
(``n_trees=60``, ``--epochs 150`` DNN epochs), cached through the versioned
artifact store (``--cache``): a rerun with the same settings loads it, on
any device, instead of refitting. ``--device cpu`` runs the plain PyTorch
path on the host.
"""
import argparse
import pathlib
import sys


def _fit_oracle(full: bool, cache: pathlib.Path, epochs: int, seed: int,
                device: str):
    from repro_torch import api
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig

    if full:
        cfg = ProfetConfig(members=("linear", "forest", "dnn"), n_trees=60,
                           dnn_epochs=epochs, seed=seed)
        return api.fit_or_load(
            cache, cfg, device=device,
            fit_fn=lambda: LatencyOracle.fit(workloads.generate(), cfg,
                                             device=device))
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "ResNet18"))
    cfg = ProfetConfig(members=("linear", "forest"), n_trees=30, seed=seed)
    return LatencyOracle.fit(ds, cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--wave", type=int, default=64,
                    help="max requests admitted per wave")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="prediction LRU entries")
    ap.add_argument("--replays", type=int, default=2,
                    help="how many times the stream is replayed (replay 2+ "
                         "exercises the cache)")
    ap.add_argument("--full", action="store_true",
                    help="paper 4-device grid + DNN member (slow fit, "
                         "cached)")
    ap.add_argument("--cache",
                    default="results/torch_serve_latency_oracle.pkl",
                    help="oracle artifact path (--full only)")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.serve import LatencyService, synthetic_requests

    oracle = _fit_oracle(args.full, pathlib.Path(args.cache), args.epochs,
                         args.seed, args.device)
    reqs = synthetic_requests(oracle, n=args.requests, seed=args.seed)
    service = LatencyService(oracle, max_wave=args.wave,
                             cache_size=args.cache_size)

    print(f"pairs: {', '.join(f'{a}->{t}' for a, t in oracle.pairs())}")
    print(f"warm-up: {service.stats.warmup_ms:.0f} ms (bank + kernel "
          "library + MLP bucket shapes before traffic)")
    for replay in range(1, args.replays + 1):
        for r in reqs:
            service.submit(r)
        service.run()
        s = service.stats
        print(f"replay {replay}: {s.requests} reqs  {s.waves} waves  "
              f"{s.fused_calls} fused calls  {s.cache_hits} cache hits  "
              f"{s.errors} errors  p50 {s.p50_ms:.2f} ms  "
              f"p99 {s.p99_ms:.2f} ms  {s.requests_per_s:.0f} req/s")

    done = service.finished[:4]
    for sr in done:
        r = sr.result
        print(f"  req {sr.uid}: {r.anchor}->{r.target} "
              f"{r.workload.model} b{r.workload.batch} p{r.workload.pix} "
              f"[{r.mode}] {r.latency_ms:.2f} ms  ${r.price_hr:.3f}/hr")
    return 0


if __name__ == "__main__":
    sys.exit(main())

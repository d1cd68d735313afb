"""PROFET advisor CLI — the paper's end-to-end scenario (Fig 3) as a
framework feature: profile once on an anchor instance, get predicted latency
+ cost on every catalog device, and a recommendation.

    PYTHONPATH=src python -m repro_torch.launch.profet_advise \
        --anchor T4 --model VGG16 --batch 64 --pix 128 [--device cpu]

The oracle is fit on the card (``--device``, default ``cuda``) on the
offline workload grid and persisted through the versioned
``repro_torch.api`` artifact store. The artifact carries a ProfetConfig
fingerprint, so rerunning with different ``--epochs``/``--seed`` refits
instead of silently reusing a stale cache; it holds no tensors, so a cache
written on the card loads with ``--device cpu`` and the other way round.
The candidate sweep is answered through the oracle's batched plan ->
execute engine (``predict_many``): one stacked dispatch for every
candidate, not one round-trip per candidate.
"""
import argparse
import pathlib
import sys


def fit_or_load(cache_path: pathlib.Path, *, dnn_epochs: int = 150,
                seed: int = 0, device="cuda"):
    """Load the cached oracle onto ``device`` if it matches (dnn_epochs,
    seed); else refit there."""
    from repro_torch import api
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig

    cfg = ProfetConfig(dnn_epochs=dnn_epochs, seed=seed)
    return api.fit_or_load(
        cache_path, cfg, device=device,
        fit_fn=lambda: api.LatencyOracle.fit(workloads.generate(), cfg,
                                             device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--anchor", default="T4",
                    help="instance the profile was taken on")
    ap.add_argument("--model", default="VGG16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pix", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10_000,
                    help="training steps for the cost estimate")
    ap.add_argument("--cache", default="results/torch_profet_cache.pkl")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import api
    from repro_torch.core import simulator

    oracle = fit_or_load(pathlib.Path(args.cache), dnn_epochs=args.epochs,
                         seed=args.seed, device=args.device)
    workload = api.Workload(args.model, args.batch, args.pix)

    # client-side step: run once on the anchor with profiling enabled
    meas = simulator.measure(args.anchor, *workload.case)

    print(f"workload: {args.model} batch={args.batch} pix={args.pix} "
          f"(profiled on {args.anchor})\n")
    print(f"{'device':8s} {'pred ms/batch':>14s} {'$/hr':>7s} "
          f"{'$ for ' + str(args.steps) + ' steps':>18s}")
    rows = oracle.advise(args.anchor, workload, profile=meas.profile,
                         measured_ms=meas.latency_ms)
    for r in rows:
        tag = " (anchor, measured)" if r.mode == api.MODE_MEASURED else ""
        print(f"{r.target:8s} {r.latency_ms:14.2f} {r.price_hr:7.3f} "
              f"{r.cost_usd(args.steps):18.4f}{tag}")

    fastest = min(rows, key=lambda r: r.latency_ms)
    cheapest = min(rows, key=lambda r: r.cost_usd(args.steps))
    print(f"\n({len(rows) - 1} candidates answered through one "
          f"predict_many batch)")
    print(f"fastest:  {fastest.target} ({fastest.latency_ms:.1f} ms/batch)")
    print(f"cheapest: {cheapest.target} "
          f"(${cheapest.cost_usd(args.steps):.4f} for {args.steps} steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

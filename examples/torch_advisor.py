"""PROFET as a first-class framework feature on the PyTorch port: the
instance advisor, the twin of ``examples/advisor.py``.

The paper's end-to-end scenario (Fig 3 + the serverless demo of §IV): a
client profiles a CNN training workload ONCE on the instance they already
have, and PROFET predicts latency + cost on every other instance in the
catalog — including devices newer than anything in the training set
(Table VI) and TPU chips (beyond paper). All prediction goes through the
``repro_torch.api`` facade: one ``advise`` call answers every target.

    PYTHONPATH=src python examples/torch_advisor.py [--device cpu]

The oracle (its forest kernels and DNN heads) runs on ``--device``,
``cuda`` by default; asking for it without a card raises.
"""
import argparse

from repro_torch import api
from repro_torch.core import simulator, workloads
from repro_torch.core.devices import PAPER_DEVICES, UNSEEN_DEVICES
from repro_torch.core.predictor import ProfetConfig

ANCHOR = "T4"
WORKLOAD = api.Workload("ResNet50", 64, 128)
TRAIN_STEPS = 50_000


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the oracle runs (cuda or cpu)")
    args = ap.parse_args(argv)

    print(f"fitting PROFET on the offline grid (anchors={ANCHOR}) ...")
    targets = PAPER_DEVICES + UNSEEN_DEVICES + ("TPUv5e",)
    # the grid must cover every target the advisor answers for
    ds = workloads.generate(devices=targets)
    train, _ = workloads.split_cases(ds.cases, test_frac=0.2, seed=0)
    oracle = api.LatencyOracle.fit(ds, ProfetConfig(dnn_epochs=100), train,
                                   anchors=(ANCHOR,), targets=targets,
                                   device=args.device)

    meas = simulator.measure(ANCHOR, *WORKLOAD.case)
    print(f"\nworkload {WORKLOAD.case} profiled on {ANCHOR}: "
          f"{meas.latency_ms:.1f} ms/batch\n")
    print(f"{'device':8s} {'ms/batch':>9s} {'$/hr':>7s} "
          f"{'$/{:,} steps'.format(TRAIN_STEPS):>15s}")
    rows = oracle.advise(ANCHOR, WORKLOAD, profile=meas.profile,
                         measured_ms=meas.latency_ms, targets=targets)
    for r in rows:
        print(f"{r.target:8s} {r.latency_ms:9.1f} {r.price_hr:7.3f} "
              f"{r.cost_usd(TRAIN_STEPS):15.3f}")
    fastest = min(rows, key=lambda r: r.latency_ms)
    cheapest = min(rows, key=lambda r: r.cost_usd(TRAIN_STEPS))
    print(f"\n-> fastest: {fastest.target}  |  cheapest: {cheapest.target}")
    print("(the anchor profile reveals only (op name, aggregated ms) rows —")
    print(" the client's model architecture stays private)")
    return rows


if __name__ == "__main__":
    main()

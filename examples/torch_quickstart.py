"""Quickstart on the PyTorch port, the twin of ``examples/quickstart.py``:
the two halves of this repo in about a minute.

1. The FRAMEWORK: build an assigned architecture (reduced config), run a
   few training steps, then serve the trained model through the port's
   ``Engine`` and decode a few tokens.
2. The PAPER (PROFET), through the public ``repro_torch.api`` service
   layer: fit an oracle once, persist it (versioned), load it and query
   it (``api.LatencyOracle.fit`` / ``api.save`` / ``api.load(...).predict``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` for both halves; asking for it without a
card raises.
"""
import argparse
import pathlib
import tempfile

from repro_torch import api
from repro_torch.configs import base as CB
from repro_torch.core import simulator, workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import Trainer, TrainConfig


def framework_quickstart(device: str, steps: int = 30) -> dict:
    print("=== framework: train + serve llama3.2-1b (reduced config) ===")
    cfg = CB.get_config("llama3.2-1b", smoke=True)
    trainer = Trainer(cfg, TrainConfig(seq_len=128, global_batch=8,
                                       num_steps=steps, log_every=10),
                      device=device)
    final = trainer.run()
    print(f"trained {cfg.param_count()/1e6:.2f}M params, "
          f"loss {trainer.history[0]['loss']:.3f} -> {final['loss']:.3f}")

    eng = Engine(cfg, trainer.model, batch_slots=2, max_len=64)
    r = eng.submit([1, 2, 3, 4], max_new_tokens=8)
    eng.run()
    print(f"decoded: {r.output}  ({eng.stats.tokens_per_s:.1f} tok/s)\n")
    return {"losses": [h["loss"] for h in trainer.history],
            "decoded": r.output}


def profet_quickstart(device: str, dnn_epochs: int = 60) -> dict:
    print("=== PROFET: cross-instance latency prediction "
          "(repro_torch.api) ===")
    # offline phase (the cloud vendor's job): fit an oracle on a small
    # workload grid and persist it through the versioned artifact store
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "ResNet18", "VGG11"))
    train, test = workloads.split_cases(ds.cases, test_frac=0.2, seed=0)
    cfg = ProfetConfig(dnn_epochs=dnn_epochs, n_trees=30)
    oracle = api.LatencyOracle.fit(ds, cfg, train, device=device)
    path = pathlib.Path(tempfile.gettempdir()) / "torch_profet_quickstart.pkl"
    api.save(oracle, path)

    # online phase (the client's job): profile ONCE on the anchor instance,
    # then query the stored oracle (fingerprint-checked against the config)
    oracle = api.load(path, expect_config=cfg, device=device)
    workload = api.Workload.from_case(test[0])
    meas = simulator.measure("T4", *workload.case)
    r = oracle.predict(api.PredictRequest("T4", "V100", workload,
                                          profile=meas.profile))
    true = ds.latency("V100", workload.case)
    print(f"workload {workload.case}: profiled on T4 "
          f"({meas.latency_ms:.1f} ms)")
    print(f"predicted on V100: {r.latency_ms:.1f} ms | actual: {true:.1f} ms "
          f"({100*abs(r.latency_ms-true)/true:.1f}% error)")
    print("(no model architecture was ever revealed — only op-name latency"
          " aggregates)")
    return {"predicted_ms": r.latency_ms, "actual_ms": true}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where both halves run (cuda or cpu)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dnn-epochs", type=int, default=60)
    args = ap.parse_args(argv)
    return {"framework": framework_quickstart(args.device, args.steps),
            "profet": profet_quickstart(args.device, args.dnn_epochs)}


if __name__ == "__main__":
    main()

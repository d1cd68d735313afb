"""The port's examples (``examples/torch_*.py``) run on the CPU."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_serving_example_serves_both_families_on_cpu(capsys):
    """``examples/torch_serving.py`` at its SMOKE sizes: every request of
    both models gets its 12 new tokens, each inside the vocabulary
    padding."""
    out = _example("torch_serving").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert [o["arch"] for o in out] == ["llama3.2-1b", "mamba2-130m"]
    for o in out:
        assert o["generated_tokens"] == 6 * 12
        assert all(len(toks) == 12 for toks in o["outputs"])
        assert all(isinstance(t, int) and t >= 0
                   for toks in o["outputs"] for t in toks)
        assert f"[{o['arch']}] 6 requests, 3 slots" in printed


def test_torch_advisor_example_ranks_the_catalog_on_cpu(capsys):
    """``examples/torch_advisor.py``: one advise call answers every target
    of the catalog, the anchor's row is its measured latency, and the
    TPU comes out fastest."""
    rows = _example("torch_advisor").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert [r.target for r in rows] == ["M60", "T4", "K80", "V100", "A10",
                                        "P100", "TPUv5e"]
    assert all(r.latency_ms > 0 for r in rows)
    assert min(rows, key=lambda r: r.latency_ms).target == "TPUv5e"
    assert "-> fastest: TPUv5e" in printed


def test_torch_train_lm_example_recovers_on_cpu(capsys):
    """``examples/torch_train_lm.py`` at a few steps: the injected
    preemption at the midpoint is recovered from the last checkpoint and
    the run completes every step."""
    rep = _example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "6", "--ckpt-every", "2",
         "--width", "64", "--seq", "32", "--batch", "4"])
    printed = capsys.readouterr().out
    assert rep.completed_steps == 6 and rep.restarts == 1
    assert rep.preemptions == [3]
    assert "--- restart #1: recovering from" in printed
    assert np.isfinite(rep.final_metrics["loss"])


def test_torch_quickstart_example_trains_then_serves_on_cpu(capsys):
    """``examples/torch_quickstart.py`` at a few steps: the trained model
    decodes 8 tokens through ``Engine`` and the PROFET half predicts."""
    out = _example("torch_quickstart").main(
        ["--device", "cpu", "--steps", "4", "--dnn-epochs", "5"])
    printed = capsys.readouterr().out
    fw = out["framework"]
    assert len(fw["losses"]) == 4 and all(np.isfinite(fw["losses"]))
    assert len(fw["decoded"]) == 8
    assert out["profet"]["predicted_ms"] > 0
    assert "decoded:" in printed and "predicted on V100" in printed


def test_train_cli_runs_on_cpu():
    """``python -m repro_torch.launch.train --arch llama3.2-1b --smoke
    --device cpu --steps 3``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "3",
         "--log-every", "1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("training llama3.2-1b-smoke") and \
        lines[0].endswith("on cpu")
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["1", "2", "3"]
    assert lines[-1].startswith("done: step 3 loss ")

"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` in the harness (``repro_torch`` is the
program under test and may load), and nothing of ``repro_torch`` in the
reference; and a run without a card prints no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from perfbench.tests._small import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROBE = """
import importlib, json, pathlib, sys
sys.path[:0] = [{src!r}, {root!r}]
for name in {modules!r}:
    importlib.import_module(name)
for path in sorted(pathlib.Path({root!r}, "perfbench", "metrics").glob("*.py")
                   if {metrics} else []):
    spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(modules, with_metrics=True):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        modules=modules, metrics=with_metrics)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    loaded = _top_level(["perfbench.lib.cell", "perfbench.lib.catalog",
                         "perfbench.lib.tracing", "perfbench.lib.modelflops",
                         "perfbench.reference.train", "perfbench.reference.moe",
                         "perfbench.reference.ssm", "repro_torch.train.trainer",
                         "repro_torch.launch.steps"])
    assert "repro_torch" in loaded          # the program, under test
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(["perfbench.reference.train", "perfbench.reference.moe",
                         "perfbench.reference.ssm", "perfbench.reference.common"],
                        with_metrics=False)
    assert not loaded & (set(FORBIDDEN) | {"repro_torch"}), loaded


def test_run_without_a_card_prints_no_result(tmp_path):
    """No CUDA device: the run exits with a code other than 0 and prints
    no result line. The same in a checkout that holds only BENCHMARK.json
    and the benchmark's folder."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = ["--workload", "dbrx-132b.train", "--seed", str(2 ** 31 + 5),
            "--seconds", "1", "--trace", "0"]
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "perfbench/run.py", *args],
                             cwd=where, capture_output=True, text=True,
                             env=env, timeout=120)
        assert out.returncode != 0
        assert out.stdout.strip() == ""

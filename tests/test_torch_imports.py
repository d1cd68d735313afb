"""``repro_torch`` stands alone: it imports neither JAX nor the reference
package ``repro``, at run time or in its sources."""
import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax_and_no_repro():
    # a subprocess: this test process already imported jax (conftest)
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_and_no_repro_import():
    """The package, ``chip_smoke.py`` and the port's examples, which run
    where JAX is not installed."""
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                 *(ROOT / "examples").glob("torch_*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


_PROBE = '''
import sys
from repro_torch.serve.shard import _spawn_worker_main


def probe(conn, report):
    """A spawn shard worker's loop, then what it imported."""
    _spawn_worker_main(conn)
    report.send(sorted(m for m in sys.modules if m == "jax"
                       or m.startswith("jax.") or m == "repro"
                       or m.startswith("repro.")))
'''


def test_spawned_shard_worker_loads_no_jax_and_no_repro(tmp_path):
    """A spawn shard worker (a fresh interpreter that unpickles the port's
    worker loop) loads a bank from shared memory, answers a wave, and
    reports its ``sys.modules``: neither ``jax`` nor ``repro``."""
    (tmp_path / "probe_worker.py").write_text(_PROBE)
    code = f"""
import json, multiprocessing as mp, sys
sys.path.insert(0, {str(tmp_path)!r})
import numpy as np
import probe_worker
from repro_torch.api.oracle import LatencyOracle
from repro_torch.core import workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve.shard import _bank_to_spec, _release_segments
o = LatencyOracle.fit(
    workloads.generate(devices=("T4", "V100"), models=("LeNet5",)),
    ProfetConfig(members=("linear", "forest"), n_trees=4), device="cpu")
spec, segs = _bank_to_spec(o.bank)
ctx = mp.get_context("spawn")
conn, child = ctx.Pipe()
report, child_report = ctx.Pipe()
p = ctx.Process(target=probe_worker.probe, args=(child, child_report))
p.start()
conn.send(("load", 1, spec))
assert conn.recv() == ("ok",)
X = o.feature_matrix("T4", o.dataset.cases[:3])
conn.send(("exec", 1, X, np.zeros(3, np.int64)))
tag = conn.recv()[0]
conn.send(("exit",))
conn.recv()
mods = report.recv()
p.join(30)
_release_segments(segs, unlink=True)
print(json.dumps([tag, mods]))
"""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["exec_ok", []]

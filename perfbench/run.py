"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
The last line of standard output is the result, one JSON object; the
numbers that decided ``correct`` are the last lines of standard error,
each beside its limit. With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``BENCHMARK.json``). A run without the cards, or one after which JAX or
the JAX package is loaded in this process, prints no result and exits
with a code other than 0.

Kernel builds go to fixed folders inside the checkout (``build/``), so
only the first run in a checkout compiles.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start():
    """A clock of the seconds since this process started (its start time
    from /proc, where there is one; else from now)."""
    t0 = time.perf_counter()
    offset = 0.0
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        offset = max(time.clock_gettime(time.CLOCK_BOOTTIME) - started, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return lambda: offset + time.perf_counter() - t0


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it: a card set below
    700 W runs slower under load, so every figure goes beside it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def result(workload: str, seed: int, seconds: float, trace: bool, *,
           device="cuda", clock=None, **overrides) -> dict:
    """One run of ``workload``: the result line's object, its ``checks``
    (each compared number beside its limit) last. ``overrides`` go to
    ``lib.cell.run`` (``conf``, ``traffic``, ``limits``)."""
    import torch
    from perfbench.lib import catalog, cell as CELL

    wl = catalog.workload(workload)
    res = CELL.run(workload, seed, seconds, trace, device=device,
                   setup_clock=clock, **overrides)
    if trace:
        metrics = {}
        for m in catalog.metrics_of(workload, "per_layer"):
            value = catalog.reader(m["name"])(res["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"train_tokens_s": res["tokens_s"],
                    "train_peak_gb": res["peak_bytes"] / 1e9,
                    "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in catalog.metrics_of(workload, "end_to_end")}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": res["peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    tr = res["record"].trace
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in res["checks"]}
    return out


def main(argv=None) -> int:
    clock = _since_process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from perfbench.lib import catalog

    chips = catalog.workload(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}, power limit "
          f"{_power_limit()}", file=sys.stderr, flush=True)
    out = result(args.workload, args.seed, args.seconds, bool(args.trace),
                 clock=clock)
    loaded = sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"forbidden modules loaded in the run's process: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

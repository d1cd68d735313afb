"""A cell's train step by phase on the card: the program's trainer, built
as a run builds it, warmed up, then a few steps under ``torch.profiler``;
the device's idle time, the host's wall time and its kernel launches split
among the program's spans (``lib/phases.py``) and its counters
(``repro_torch.spans.drain()``), per optimizer step.

    python3 perfbench/tools/trace_phases.py --workload <cell> --seed <n> \\
        [--warm 5] [--steps <trace_steps>] --out phases-<cell>.json

``residual_s`` is the traced wall time less the device's busy time less
the idle time the phases and ``(outside)`` hold: what the traced interval
(first to last event) misses of the wall clock.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
PER_STEP = {"forward_idle_ms": ("train_step/forward", "idle_s"),
            "backward_idle_ms": ("train_step/backward", "idle_s"),
            "optimizer_idle_ms": ("train_step/optimizer", "idle_s"),
            "data_wait_ms": ("train_step/data", "host_s")}


def measure(torch, conf: dict, traffic: dict, seed: int, device, *,
            warm: int, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import spans
    from perfbench.lib import cell as CELL, phases
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer = CELL.build_program(torch, conf, traffic, seed, device)
    for _ in range(traffic["compare_steps"] + warm):
        trainer.train_one()
    spans.drain()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_one()
        sync()
        wall = time.perf_counter() - t0
    counters = spans.drain()
    out = phases.of_events(prof.events())
    table = out["phases"]
    per_step = {name: 1e3 * table[span][key] / steps
                for name, (span, key) in PER_STEP.items() if span in table}
    launches = sum(table[p]["launches"] for p in phases.PHASES if p in table)
    per_step["step_launches"] = launches / steps
    if counters.get("moe/slots"):
        per_step["moe_slot_fill"] = (100.0 * counters.get("moe/kept", 0)
                                     / counters["moe/slots"])
        per_step["moe_dropped_share"] = (
            100.0 * (1 - counters.get("moe/kept", 0) / counters["moe/choices"]))
    held = sum(v["idle_s"] for v in table.values())
    return {"steps": steps, "window_s": wall, **out,
            "residual_s": wall - out["busy_s"] - held,
            "residual_share": (wall - out["busy_s"] - held) / wall,
            "per_step": per_step, "counters": counters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch
    from perfbench.lib import catalog
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    wl = catalog.workload(args.workload)
    conf, traffic = catalog.config(wl["config"]), catalog.traffic(wl["traffic"])
    res = measure(torch, conf, traffic, args.seed, "cuda", warm=args.warm,
                  steps=args.steps or traffic["trace_steps"])
    res = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), **res}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

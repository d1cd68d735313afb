"""The readings that a cell's comparison limits are set from, on the card
at the cell's own sizes, in one process:

- the program against the reference on each of ``--seeds`` (the lower
  readings: what sound runs give);
- on each of ``--control-seeds``: the control, the reference in fp8 put
  in the program's place, against the float32 reference; and the fault
  of a step that leaves half of the batch out, taken the mean over the
  rest, planted in the reference put in the program's place.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --out chiprun_out/calibrate-<cell>.json

A step that returns its state unchanged needs no run: its update reads
0, and ``update_gap`` reads 1. The output is written again after every
seed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def lower_reading(torch, conf, traffic, seed: int, device) -> dict:
    """The program's readings against the reference's for one seed."""
    from perfbench.lib import cell as CELL, compare
    steps = traffic["compare_steps"]
    t0 = time.perf_counter()
    trainer = CELL.build_program(torch, conf, traffic, seed, device)
    prog = CELL.program_readings(torch, trainer, conf, seed, steps, device)
    del trainer
    CELL.free(torch)
    t1 = time.perf_counter()
    ref = CELL.reference_readings(conf, traffic, seed, steps, device)
    t2 = time.perf_counter()
    return {"seed": seed, "numbers": compare.numbers(prog, ref),
            "program_s": t1 - t0, "reference_s": t2 - t1,
            "program": prog, "reference": ref}


def upper_readings(conf, traffic, seed: int, device, ref=None) -> dict:
    """The control's and the half-batch fault's numbers for one seed."""
    from perfbench.lib import cell as CELL, compare
    steps = traffic["compare_steps"]
    ref = ref or CELL.reference_readings(conf, traffic, seed, steps, device)
    t0 = time.perf_counter()
    fp8 = CELL.reference_readings(conf, traffic, seed, steps, device,
                                  prec="fp8")
    t1 = time.perf_counter()
    half = CELL.reference_readings(conf, traffic, seed, steps, device,
                                   rows="half")
    return {"seed": seed, "control": compare.numbers(fp8, ref),
            "half_batch": compare.numbers(half, ref), "control_s": t1 - t0,
            "reference": ref, "control_readings": fp8, "half_readings": half}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
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
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "lower": [], "upper": []}
    refs = {}

    def save():
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    for seed in seeds:
        r = lower_reading(torch, conf, traffic, seed, "cuda")
        refs[seed] = r["reference"]
        out["lower"].append(r)
        print(json.dumps({"seed": seed, **r["numbers"],
                          "program_s": r["program_s"],
                          "reference_s": r["reference_s"]}), flush=True)
        save()
    for seed in control:
        r = upper_readings(conf, traffic, seed, "cuda", refs.get(seed))
        out["upper"].append(r)
        print(json.dumps({"seed": seed, "control": r["control"],
                          "half_batch": r["half_batch"]}), flush=True)
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())

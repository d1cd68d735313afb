#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py [--requests 500] [--epochs 150] [--out FILE]

Run from the root of a checkout on a machine with one NVIDIA H100. It
builds the CUDA kernels of ``src/repro_torch/csrc`` and drives the port's
main path: it fits the paper-grid PROFET predictor (4 devices, 346 cases,
linear + 60-tree forest + DNN members, 150 DNN epochs, random DNN init from
seed 0) on the card, then

  1. serves the ``synthetic_requests`` stream twice through
     ``LatencyService`` (waves of 64; banked: one grouped forest launch per
     wave) and one wave through the per-group path (single-forest kernel);
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes the serving run gave it and on random forests (max abs
     difference must be 0), and times both, and the one PyTorch call that
     computes the same function where there is one (``mean(0)`` for the
     tree mean; none computes a forest traversal);
  3. holds the card's answers for one wave against the same model run with
     ``device="cpu"`` (rtol 1e-5, the float32 DNN member's bar);
  4. replays the stream once more through a fresh service under
     ``torch.profiler`` and prints the card's idle share and top kernels
     (profiler overhead included; the untraced replays give the latency).

Launch counts are zeroed just before step 1 and read just after it. Any
failed check exits non-zero. The last line is the JSON result; the line
before it lists every kernel with its launches, error and times.
Without CUDA, or outside a checkout, it exits 2 and prints no result.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate, and float64 outside the tensor
# cores (the kernels compare and add in float64)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
RTOL_CARD_VS_CPU = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"ok: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_kernel_ms(torch, fn, iters=200, reps=5):
    """Device time of one ``fn()`` launch: ``iters`` launches captured in a
    CUDA graph, replayed ``reps`` times between CUDA events; the median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[reps // 2]


def time_plain_ms(torch, fn, iters=20):
    """Time of one ``fn()`` call between CUDA events (the plain versions
    synchronise inside, so they cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def path_bytes(torch, forest_eval, X, gid, feat, thr, left, right, depth):
    """What one traversal of these rows must read, counted per field off the
    plain traversal's levels: at an internal node its feat (4 B) and thr
    (8 B), the one child it follows (4 B) and x[row, feat] (8 B); feat at a
    leaf that stopped a walk (4 B); value at each node a walk ends on
    (8 B). Each distinct address counts once. Returns (bytes, compares)."""
    D = X.shape[1]
    rows = torch.arange(X.shape[0], device=X.device)[None, :]
    internal, edges, xreads, stops = [], [], [], []
    compares = 0

    def on_step(flat, F, within, go_left):
        nonlocal compares
        live = within & (F >= 0)
        compares += int(live.sum())
        internal.append(flat[live])
        edges.append((2 * flat + (~go_left).long())[live])
        xreads.append((rows * D + F)[live])
        stops.append(flat[within & (F < 0)])

    ends = forest_eval.leaf_nodes_grouped_plain(
        X, gid, feat, thr, left, right, depth, on_step=on_step)

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel()) if parts else 0

    return (12 * distinct(internal) + 4 * distinct(edges)
            + 8 * distinct(xreads) + 4 * distinct(stops)
            + 8 * distinct([ends.reshape(-1)])), compares


def replay_once(svc, reqs) -> dict:
    """Submit every request, drain the service, and summarise this replay
    alone: service latency (queue + execute) percentiles over its
    requests, and requests per second of its drain."""
    import numpy as np
    before = dict(vars(svc.stats))
    svc.take_finished()
    for r in reqs:
        svc.submit(r)
    t0 = time.perf_counter()
    svc.run()
    wall = time.perf_counter() - t0
    lat = [sr.latency_ms for sr in svc.take_finished()]
    s = svc.stats
    return {"requests": len(lat), "waves": s.waves - before["waves"],
            "banked_waves": s.fused_calls - before["fused_calls"],
            "cache_hits": s.cache_hits - before["cache_hits"],
            "errors": s.errors - before["errors"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(lat) / wall}


def traced_replay(torch, svc, reqs) -> dict:
    """One replay of a fresh service under ``torch.profiler``: the share of
    its wall time the card spent running kernels, and the kernels that
    took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        svc.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # a trace without device events measured nothing: say so, not "idle"
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if kernels else None,
            "device_idle_share": 1.0 - busy_us / wall_us if kernels else None,
            "top_kernels": [{"name": e.key[:60], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_forest_stack(torch, device, d=33, seed=0):
    """Ragged random forests grown on random data (60 trees each, depths up
    to 20), one grown on a constant target (depth 0), stacked like the
    bank."""
    import numpy as np
    from repro_torch.core.regressors import RandomForestRegressor
    rng = np.random.default_rng(seed)
    forests = []
    for g in range(4):
        X = rng.normal(size=(120 + 60 * g, d))
        y = (np.full(len(X), 2.0) if g == 1 else
             X[:, 0] * (g + 1) + np.sin(3 * X[:, 1]) + rng.normal(size=len(X)))
        forests.append(RandomForestRegressor(
            n_estimators=60, max_depth=8 + 4 * g, seed=seed + g,
            device=device).fit(X, y).forest_)
    n_max = max(f.feat.shape[1] for f in forests)
    out = {}
    for k, fill in (("feat", -1), ("thr", 0.0), ("left", 0), ("right", 0),
                    ("value", 0.0)):
        a = np.full((4, 60, n_max), fill, getattr(forests[0], k).dtype)
        for g, f in enumerate(forests):
            a[g, :, :f.feat.shape[1]] = getattr(f, k)
        out[k] = torch.from_numpy(a).to(device)
    out["depth"] = torch.tensor([f.depth for f in forests],
                                dtype=torch.int64, device=device)
    Xq = torch.from_numpy(rng.normal(size=(100, d))).to(device)
    gq = torch.from_numpy(rng.integers(0, 4, size=100)).to(device)
    return out, Xq, gq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the result lines to this JSON file")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"error: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.convert import profet_from_numpy, profet_to_numpy
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig
    from repro_torch.kernels import forest_eval
    from repro_torch.serve import LatencyService, synthetic_requests

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    forest_eval.library()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: forest_eval.cu in {report['build_s']:.1f} s")

    # -- fit the --full configuration on the card -------------------------
    t0 = time.perf_counter()
    cfg = ProfetConfig(members=("linear", "forest", "dnn"), n_trees=60,
                       dnn_epochs=args.epochs, seed=args.seed)
    oracle = LatencyOracle.fit(workloads.generate(), cfg, device="cuda")
    report["fit_s"] = time.perf_counter() - t0
    bank = oracle.bank
    check(bank is not None and oracle.bank_error is None,
          f"bank built on the card ({oracle.bank_error})")
    f = bank.forest
    G, T, N = f["feat"].shape
    print(f"fit: {report['fit_s']:.1f} s; bank (G, T, N) = ({G}, {T}, {N}), "
          f"D = {bank.n_features}, depth {f['depth'].tolist()}")
    check(f["feat"].is_cuda and bank.dnn[0][0]["w"].is_cuda,
          "forest stack and DNN heads live on the card")

    # -- 1. the main path: serving through the kernels ---------------------
    svc = LatencyService(oracle, max_wave=64)
    check(not svc.stats.degraded, f"service warm-up on the card "
          f"({svc.stats.warmup_ms:.1f} ms; {svc.stats.degraded_reason})")
    waves = []
    execute = bank.execute

    def recording_execute(X, gids):
        waves.append((np.array(X), np.array(gids)))
        return execute(X, gids)

    bank.execute = recording_execute
    reqs = synthetic_requests(oracle, n=args.requests, seed=args.seed)
    wave_plans = [oracle.plan(r) for r in reqs[:64]]

    forest_eval.reset_launches()
    replays = []
    for replay in (1, 2):
        replays.append(replay_once(svc, reqs))
        print(f"replay {replay}: {json.dumps(replays[-1])}")
    per_group = oracle.execute(wave_plans, banked=False)
    counts = dict(forest_eval.launches)
    bank.execute = execute
    report["replays"] = replays

    s = svc.stats
    check(s.requests == 2 * args.requests and s.errors == 0
          and all(r["requests"] == args.requests for r in replays),
          f"{s.requests} requests served, {s.errors} errors")
    check(not s.degraded and oracle.bank_error is None,
          "no degraded state and no bank error after serving")
    check(bank.forest_launches == s.fused_calls == len(waves) > 0,
          f"one grouped forest launch per banked wave "
          f"({bank.forest_launches} launches, {s.fused_calls} banked waves)")
    check(counts["leaf_values_grouped"] == len(waves),
          f"grouped kernel launched once per banked wave "
          f"({counts['leaf_values_grouped']})")
    check(not per_group.banked and counts["leaf_values"]
          == per_group.fused_calls > 0,
          f"per-group wave launched the single-forest kernel once per pair "
          f"({counts['leaf_values']} launches)")
    check(counts["tree_mean"] == len(waves) + per_group.fused_calls,
          f"tree-mean kernel launched after every traversal "
          f"({counts['tree_mean']})")
    print(f"launches on the main path: {json.dumps(counts)}")

    # -- 2. kernels against their plain versions ---------------------------
    X_np, g_np = max(waves, key=lambda w: len(w[0]))
    X = torch.from_numpy(X_np).to(dev)
    gid = torch.from_numpy(g_np).to(dev)
    fa = (f["feat"], f["thr"], f["left"], f["right"], f["value"])
    m = X.shape[0]
    pair = bank.pairs[int(np.bincount(g_np).argmax())]
    rf = oracle.profet.cross[pair].models["forest"]
    sf = rf.device_forest()
    sa = (sf["feat"], sf["thr"], sf["left"], sf["right"], sf["value"])
    Xs = X[gid == bank.gid[pair]].contiguous()
    depth1 = rf.forest_.depth
    rnd, Xr, gr = random_forest_stack(torch, dev)
    ra = (rnd["feat"], rnd["thr"], rnd["left"], rnd["right"], rnd["value"])
    print(f"kernel shapes: wave of {m} rows over {G} groups; per-group "
          f"{Xs.shape[0]} rows of pair {pair} (depth {depth1}); random "
          f"stack {tuple(rnd['feat'].shape)} depth {rnd['depth'].tolist()}")

    def max_err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def grouped(backend, x=X, g=gid, args=fa, depth=f["depth"]):
        return forest_eval.leaf_values_grouped(x, g, *args, depth,
                                               backend=backend)

    def single(backend, x=Xs, args=sa, depth=depth1):
        return forest_eval.leaf_values(x, *args, depth=depth,
                                       backend=backend)

    leaves = grouped("cuda")
    cpu_leaves = forest_eval.leaf_values_grouped(
        X.cpu(), gid.cpu(), *(a.cpu() for a in fa), f["depth"].cpu())
    errs = {
        "leaf_values_grouped": max(
            max_err(leaves, grouped("torch")),
            max_err(leaves.cpu(), cpu_leaves),
            max_err(grouped("cuda", Xr, gr, ra, rnd["depth"]),
                    grouped("torch", Xr, gr, ra, rnd["depth"]))),
        "leaf_values": max(
            max_err(single("cuda"), single("torch")),
            max(max_err(single("cuda", Xr, tuple(a[g] for a in ra),
                               int(rnd["depth"][g])),
                        single("torch", Xr, tuple(a[g] for a in ra),
                               int(rnd["depth"][g]))) for g in range(4))),
        "tree_mean": max(
            max_err(forest_eval.tree_mean(leaves),
                    forest_eval.tree_mean(leaves, backend="torch")),
            max_err(forest_eval.tree_mean(leaves).cpu(),
                    forest_eval.tree_mean(cpu_leaves))),
    }
    for name, e in errs.items():
        check(e == 0.0, f"{name} kernel equals its plain version "
              f"(max abs err {e})")

    path_g, cmp_g = path_bytes(torch, forest_eval, X, gid, *fa[:4],
                               f["depth"])
    path_s, cmp_s = path_bytes(
        torch, forest_eval, Xs,
        torch.zeros(Xs.shape[0], dtype=torch.int64, device=dev),
        *(a[None] for a in sa[:4]),
        torch.tensor([depth1], dtype=torch.int64, device=dev))
    ms_s = Xs.shape[0]
    # + gid and each used group's depth bound in, the (T, rows) leaves out
    work = {
        "leaf_values_grouped": (
            path_g + m * 8 + int(gid.unique().numel()) * 8 + T * m * 8,
            cmp_g),
        "leaf_values": (path_s + T * ms_s * 8, cmp_s),
        "tree_mean": (T * m * 8 + m * 8, T * m + m),
    }
    timed = {
        "leaf_values_grouped": (lambda: grouped("cuda"),
                                lambda: grouped("torch")),
        "leaf_values": (lambda: single("cuda"), lambda: single("torch")),
        "tree_mean": (lambda: forest_eval.tree_mean(leaves),
                      lambda: forest_eval.tree_mean(leaves,
                                                    backend="torch")),
    }
    meta = {
        "leaf_values_grouped": "src/repro/kernels/forest_eval.py:217",
        "leaf_values": "src/repro/kernels/forest_eval.py:158",
        "tree_mean": "src/repro/kernels/forest_eval.py:38",
    }
    # one PyTorch call for the same function, timed as a yardstick only;
    # it sums in its own order, so it is not bitwise equal to tree_mean
    library = {"tree_mean": lambda: leaves.mean(0)}
    report["tree_mean_vs_library_max_abs"] = max_err(
        forest_eval.tree_mean(leaves), leaves.mean(0))
    print(f"tree_mean against mean(0): max abs diff "
          f"{report['tree_mean_vs_library_max_abs']} (not bitwise)")
    kernels = []
    for name, (kern, plain) in timed.items():
        b_ms, b_by = bound_ms(*work[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/forest_eval.cu",
            "replaces": meta[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": time_kernel_ms(torch, kern),
            "plain_ms": time_plain_ms(torch, plain), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": (time_kernel_ms(torch, library[name])
                           if name in library else None)})
        print(f"{name}: {json.dumps(kernels[-1])}")
    report["work"] = {k: {"bytes": v[0], "ops": v[1]} for k, v in work.items()}

    # -- 3. card against CPU, and the answers themselves ---------------------
    cpu_oracle = LatencyOracle(profet_from_numpy(
        profet_to_numpy(oracle.profet), device="cpu"), oracle.dataset)
    on_card = oracle.execute(wave_plans)
    on_cpu = cpu_oracle.execute(wave_plans)
    lat_card, lat_cpu = on_card.latencies(), on_cpu.latencies()
    check(on_card.banked and on_cpu.banked, "both waves banked")
    check(lat_card.shape == (64,) and np.isfinite(lat_card).all()
          and (lat_card > 0).all(), "64 finite positive latencies")
    rel = float(np.max(np.abs(lat_card - lat_cpu) / np.abs(lat_cpu)))
    check(rel <= RTOL_CARD_VS_CPU,
          f"card agrees with CPU within rtol {RTOL_CARD_VS_CPU} "
          f"(max rel err {rel:.3e})")
    pg = per_group.latencies()
    rel_pg = float(np.max(np.abs(pg - lat_card) / np.abs(lat_card)))
    check(rel_pg <= RTOL_CARD_VS_CPU,
          f"per-group path agrees with the banked path (max rel err "
          f"{rel_pg:.3e})")
    report.update(card_vs_cpu_max_rel=rel, per_group_vs_banked_max_rel=rel_pg,
                  kernels=kernels, launches=counts)

    # -- 4. a traced replay: where the card's time goes ----------------------
    trace = traced_replay(torch, LatencyService(oracle, max_wave=64), reqs)
    print(f"trace: {json.dumps(trace)}")
    report["trace"] = trace

    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

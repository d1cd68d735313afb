#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py [--requests 500] [--epochs 150] [--seed 0]
                          [--out FILE]

Run from the root of a checkout on a machine with one NVIDIA H100. It
builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all at once) and drives the port's two paths.

The PROFET path: it fits the paper-grid predictor (4 devices, 346 cases,
linear + 60-tree forest + DNN members, 150 DNN epochs, random DNN init from
seed 0) on the card, then

  1. serves the ``synthetic_requests`` stream twice through
     ``LatencyService`` (waves of 64; banked: one fused grouped launch,
     traversal and tree mean, per wave; no separate tree-mean launch) and
     one wave through the per-group path (one fused single-forest launch
     per pair);
  2. holds each forest kernel, both traversals by both of their routes
     (shared memory, the one the serving run takes, and global) and both
     fused predictions (the shared route with the tree mean as its
     epilogue), against its plain PyTorch version on the card (max abs
     difference must be 0, NaN where the plain version has NaN): at the
     shapes the serving run gave it, on random ragged forests with a
     depth-0 group, with out-of-range group ids, with groups left out, at
     1 row and at 4,096 rows drawn from the served waves; times every
     kernel at the serving shapes, each fused prediction in turns with the
     two launches it replaces, and both traversal routes in turns at 512
     to 4,096 rows (and says which one the wrapper takes there: the shared
     route only while its grid fits the card in one round), the plain
     versions, and the one PyTorch call that computes the same function
     where there is one (``mean(0)`` for the tree mean; none traverses a
     forest);
  3. holds the card's answers for one wave against the same model run with
     ``device="cpu"`` (rtol 1e-5, the float32 DNN member's bar);
  4. replays the stream once more through a fresh service under
     ``torch.profiler`` and prints the card's idle share and top kernels
     (profiler overhead included; the untraced replays give the latency);
  5. saves the fitted oracle with ``repro_torch.api.save`` and loads it on
     the card and on the CPU (linear and forest members bit for bit, the
     answers within rtol 1e-5); serves the stream through a 2-worker
     thread-mode shard plane in process (one fused grouped launch per
     shard slice, no plain version); launches 2 TCP shard workers on the
     card and serves the stream over HTTP (``BackgroundServer``,
     ``replay`` with 8 clients) through ``LatencyService(shard_plane=...,
     supervise=...)``: every request answers within rtol 1e-5 of the
     unsharded service, each worker runs one fused launch per slice and
     holds a CUDA context (its pid in ``nvidia-smi``); kills worker 1
     mid-replay (requests riding it retry once), waits for the supervisor
     to respawn it and serves again; then float64-only oracles through
     thread, spawn and TCP planes, bit for bit as the unsharded bank;
 11. (run after phase 5, on the phase-1 oracle) live calibration:
     ``serve_calibrated``'s drift-injection replay over HTTP (4 clients,
     rounds of 120 ``synthetic_requests``, the first pair's truth x1.6
     from round 1, noise 0.01; ``Calibrator`` at the CLI's configuration,
     stepping every 0.05 s in its thread, with a ``CalibrationStore``):
     the reference's 6 rounds, then on until the promotion and 2 rounds
     after it (at most 20). Every request answers; drift, a refit, a
     passed canary and a promotion happen mid-traffic; the service ends
     on the ``+cal`` epoch with the drifted pair's rolling MAPE below the
     trigger; the promoted candidate's bank runs fused grouped launches
     and no forest wrapper takes its plain version. Prints each round's
     p50 / p99 / req/s beside what the calibrator had in flight (refit,
     canary, swap), and the refit and canary seconds and the swap and
     warm-up ms. ``CalibrationStore.recover`` gives the promoted epoch on
     the card and on the CPU, linear and forest members bit for bit; then
     ``build_candidate`` on the frozen buffer, on the card and on a CPU
     copy of the oracle: linear and forest members bit for bit, each
     candidate's held-out MAPE on the drifted pair below the trigger (the
     DNN member trains on each device, so it is not compared bitwise);
 12. the paper's baselines on the paper grid's split (20% held out, seed
     0): ``MLPredictModel(epochs=300, seed=0)`` fitted on the card and on
     the CPU, held-out MAPE per target device within 3 points of each
     other; Paleo and Habitat on the host, their MAPE printed.

The LM serving path, at the full published widths and depths, random
float32 weights from ``--seed`` cast to bfloat16 as the prefill step's:

  6. the llama3.2-1b prefill step on (4, 2048) tokens: exactly 16
     flash-attention launches per call, finite next tokens and logits,
     median step time. The model (params rounded to bf16 values) is held
     end to end against the same model with the plain attention in float32
     (atol 1e-4, rtol 1e-4, the CPU parity tests' bar); in bf16 its
     last-position logits may end at most 2x as far from that float32
     plain run as the bf16 plain run's do;
  7. the mamba2-130m prefill step on (4, 2048) tokens: exactly 24 SSD-scan
     launches per call, the same checks;
  8. ``Engine`` serving 8 requests for each model (4 slots, 16 new tokens,
     max_len 128, continuous), as ``launch/serve.py`` does by default; it
     launches neither kernel (prefill goes through the decode step);
  9. the two kernels against their plain versions at the inputs phases 6
     and 7 gave them and at random shapes (flash: GQA, MQA, KV == H, D 16,
     32, 64 and 128, S 300 and 1000, f32 and bf16; SSD: P 32, 64 and 128,
     N 64 and 128, chunks 64, 128 and 256, 16 chunks at S 4096), bars f32
     atol 2e-5 / rtol 1e-4 and bf16 atol 6e-3 / rtol 3e-2 (SSD after
     dividing by max |ref|); two bf16 launches at the main path's inputs
     must give the same bits; each library's SASS must hold tensor-core
     ``HMMA`` instructions (``cuobjdump``); timed with their plain versions
     and, for attention, PyTorch's ``scaled_dot_product_attention`` (timed
     only; the port never calls it), and the float32 kernels at the same
     shapes (cast), held to the float32 bar and timed the same way;
 10. one prefill of each model under ``torch.profiler``: idle share and
     top device kernels.

Launch counts are zeroed just before each path's main run and read just
after it. Any failed check exits non-zero. The last line is the JSON
result; the line before it lists every kernel with its launches, error,
times and bound. Without CUDA, or outside a checkout, it exits 2 and prints
no result.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate; float64 outside the tensor cores
# (the forest kernels compare and add in float64); dense bf16 on the tensor
# cores (the LM kernels' inputs are bf16 on the main path); float32 outside
# the tensor cores (the LM kernels' float32 route)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
LM_BATCH, LM_SEQ = 4, 2048
KERNEL_SOURCES = ("forest_eval", "flash_attention", "ssd_scan")
RTOL_CARD_VS_CPU = 1e-5
# how much farther from the float32 plain run the bf16 run through a kernel
# may end than the bf16 plain run
BF16_VS_PLAIN = 2.0


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


# the device functions of src/repro_torch/csrc, as the profiler names them
# (the shared route's by instantiation: <kGrouped, kMean>)
FOREST_KERNELS = ("leaves_tile_kernel<true, true>",
                  "leaves_tile_kernel<false, true>",
                  "leaves_tile_kernel<true, false>",
                  "leaves_tile_kernel<false, false>",
                  "leaves_grouped_kernel", "leaves_single_kernel",
                  "tree_mean_kernel")
REPO_KERNELS = FOREST_KERNELS + (
    "flash_fwd_kernel", "flash_bf16_kernel", "ssd_scan_kernel",
    "ssd_states_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")


def is_kernel(name, key) -> bool:
    """Whether the profiler's ``key`` names device function ``name``
    (spaces ignored, so a template's arguments match however they are
    spaced)."""
    name, key = name.replace(" ", ""), key.replace(" ", "")
    return f"{name}<" in key or f"{name}(" in key


def traced(torch, run) -> dict:
    """``run()`` under ``torch.profiler``: the share of its wall time the
    card spent running kernels, the kernels that took the most device
    time, and the device time of each of the repo's own kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
                            for e in top],
            "repo_kernels": {
                name: {"calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                for e in kernels for name in REPO_KERNELS
                if is_kernel(name, e.key)}}


def traced_replay(torch, svc, reqs) -> dict:
    """One replay of a fresh service under ``torch.profiler``."""
    for r in reqs:
        svc.submit(r)
    return traced(torch, svc.run)


ROUTES = ("shared", "global")
LARGE_WAVE = 4096
# waves of rows drawn from the served ones at which both traversal routes
# are timed beside each other
WAVE_SIZES = (512, 1024, 2048, LARGE_WAVE)


def bound_ms(nbytes, ops, ops_per_s=FP64_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
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


# ---------------------------------------------------------------------------
# artifacts, sharded and HTTP serving (phase 5)
# ---------------------------------------------------------------------------


def gpu_apps() -> dict:
    """pid -> device memory (MiB) of every compute process ``nvidia-smi``
    lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(","))
        apps[int(pid)] = int(mem)
    return apps


def gpu_memory_used_mib() -> int:
    """The card's used memory as ``nvidia-smi`` reads it, all contexts."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])


def check_worker_contexts(tag, procs, stats, mib_before, card) -> dict:
    """Each shard worker process holds a CUDA context on the card. Where
    ``nvidia-smi`` lists the workers' pids, their rows say so; where it
    attributes every context to one process of its own (as behind a
    container's GPU proxy), each worker's report from its own process
    (pid, bytes its torch holds on the card) says so, and the card's used
    memory must have grown since before the workers started."""
    import os
    apps = gpu_apps()
    used = gpu_memory_used_mib()
    out = {"nvidia_smi_apps": apps, "memory_used_mib": used,
           "memory_used_before_mib": mib_before,
           "worker_pids": [p.pid for p in procs],
           "worker_cuda_bytes": [st.get("cuda_memory_allocated")
                                 for st in stats]}
    for i, (p, st) in enumerate(zip(procs, stats)):
        check(st["pid"] == p.pid != os.getpid()
              and (st.get("cuda_memory_allocated") or 0) > 0,
              f"{tag}: worker {i} (pid {p.pid}) holds "
              f"{st.get('cuda_memory_allocated')} bytes on the card, "
              "reported from its own process")
    if all(p.pid in apps for p in procs):
        out["worker_mib"] = [apps[p.pid] for p in procs]
        check(all(m > 0 for m in out["worker_mib"]),
              f"{tag}: nvidia-smi lists each worker's context: "
              f"{out['worker_mib']} MiB; card: {card}")
    else:
        check(used > mib_before,
              f"{tag}: nvidia-smi lists the card's contexts under pids "
              f"{sorted(apps)} (a GPU proxy's), not the workers' "
              f"{out['worker_pids']}; the card's used memory went from "
              f"{mib_before} to {used} MiB with the workers "
              f"({(used - mib_before) / len(procs):.0f} MiB a worker); "
              f"card: {card}")
    return out


def member_preds(torch, bank, X, gids) -> dict:
    """Each member's prediction of a bank for the rows (X, gids), as
    ``ModelBank.execute`` computes them before the median."""
    from repro_torch.core.regressors import LinearRegressor
    from repro_torch.kernels import forest_eval
    out = {}
    if bank.lin_coef is not None:
        out["linear"] = LinearRegressor.apply(LinearRegressor._design(X),
                                              bank.lin_coef[gids])
    if bank.forest is not None:
        f = bank.forest
        out["forest"] = forest_eval.predict_grouped(
            torch.from_numpy(X).to(bank.device),
            torch.from_numpy(gids).to(bank.device), f["feat"], f["thr"],
            f["left"], f["right"], f["value"], f["depth"]).cpu().numpy()
    if bank.dnn is not None:
        out["dnn"] = bank._dnn_member(X, gids)
    return out


def max_rel(np, got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def served(np, svc, reqs) -> list:
    """The service's answers to ``reqs`` in request order."""
    svc.take_finished()
    for r in reqs:
        svc.submit(r)
    svc.run()
    done = sorted(svc.take_finished(), key=lambda sr: sr.uid)
    assert all(sr.error is None for sr in done), [sr.error for sr in done]
    return np.array([sr.result.latency_ms for sr in done])


def shard_phase(torch, np, oracle, reqs, waves, wave_plans, args,
                card) -> dict:
    """Phase 5: the artifact store, HTTP serving through two TCP shard
    workers on the card (and after one is killed), a thread-mode plane in
    process, and float64-only planes of every kind."""
    import threading

    from repro_torch import api
    from repro_torch.core.predictor import ProfetConfig
    from repro_torch.kernels import forest_eval
    from repro_torch.serve import (BackgroundServer, LatencyService,
                                   LifecycleConfig, RetryPolicy,
                                   ShardPlane, launch_tcp_workers, replay)
    rep = {}
    X, gids = max(waves, key=lambda w: len(w[0]))

    # -- artifacts: save on the card, load on the card and on the CPU -----
    path = ROOT / "build" / "smoke" / "oracle.pkl"
    t0 = time.perf_counter()
    manifest = api.save(oracle, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_card = api.load(path, expect_config=oracle.config, device="cuda")
    load_s = time.perf_counter() - t0
    on_cpu = api.load(path, expect_config=oracle.config, device="cpu")
    check(on_card.bank.forest["feat"].is_cuda
          and not on_cpu.bank.forest["feat"].is_cuda,
          f"artifact ({path.stat().st_size} bytes, saved in {save_s:.2f} s, "
          f"loaded on the card in {load_s:.2f} s) reloads on the card and "
          "on the CPU")
    want = member_preds(torch, oracle.bank, X, gids)
    for name, o in (("card", on_card), ("CPU", on_cpu)):
        got = member_preds(torch, o.bank, X, gids)
        for member in ("linear", "forest"):
            check(np.array_equal(got[member], want[member]),
                  f"{name} reload: the {member} member equals the "
                  f"original's bit for bit on a wave of {len(X)} rows")
    lat = oracle.execute(wave_plans).latencies()
    lat_card = on_card.execute(wave_plans).latencies()
    lat_cpu = on_cpu.execute(wave_plans).latencies()
    rel_card, rel_cpu = max_rel(np, lat_card, lat), max_rel(np, lat_cpu,
                                                            lat_card)
    check(rel_card <= RTOL_CARD_VS_CPU,
          f"card reload answers the 64-request wave as the original "
          f"(max rel diff {rel_card:.3e}, bitwise "
          f"{bool(np.array_equal(lat_card, lat))})")
    check(rel_cpu <= RTOL_CARD_VS_CPU,
          f"CPU reload answers within rtol {RTOL_CARD_VS_CPU} of the card "
          f"(max rel diff {rel_cpu:.3e})")
    rep["artifact"] = {"bytes": path.stat().st_size, "save_s": save_s,
                       "load_card_s": load_s, "schema": manifest[
                           "schema_version"],
                       "card_reload_max_rel": rel_card,
                       "card_reload_bitwise": bool(np.array_equal(lat_card,
                                                                  lat)),
                       "cpu_reload_max_rel": rel_cpu}

    # -- the unsharded answers every sharded run is held to ---------------
    want = served(np, LatencyService(oracle, max_wave=64), reqs)

    # -- thread-mode plane in process: one fused launch per slice ---------
    with ShardPlane(workers=2, mode="thread") as tplane:
        tsvc = LatencyService(oracle, max_wave=64, shard_plane=tplane)
        check(tsvc._shard_gen is not None and not tsvc.stats.degraded,
              "thread-mode plane loaded the bank")
        before, s0 = dict(forest_eval.launches), tplane.slices
        plain0 = sum(forest_eval.plain_calls.values())
        got = served(np, tsvc, reqs)
        delta = {k: v - before[k] for k, v in forest_eval.launches.items()}
        plain = sum(forest_eval.plain_calls.values()) - plain0
        slices = tplane.slices - s0
    check(delta["predict_grouped"] == slices > 0
          and delta["leaf_values_grouped"] == 0
          and delta["leaf_values_grouped/global"] == 0
          and plain == 0,
          f"thread mode: {delta['predict_grouped']} fused grouped launches "
          f"for {slices} shard slices, {plain} plain calls")
    rel_thread = max_rel(np, got, want)
    check(rel_thread <= RTOL_CARD_VS_CPU,
          f"thread-mode plane answers {len(reqs)} requests as the "
          f"unsharded service (max rel diff {rel_thread:.3e})")
    rep["thread_plane"] = {"slices": slices, "launches": delta,
                           "max_rel": rel_thread}

    # -- the same replay over HTTP, unsharded: the yardstick --------------
    usvc = LatencyService(oracle, max_wave=64, cache_size=0)
    ubg = BackgroundServer(usvc, host="127.0.0.1", port=0).start()
    try:
        r = replay(ubg.host, ubg.port, reqs, clients=8)
    finally:
        ubg.stop()
    got = np.array([x["latency_ms"] if x else np.nan for x in r["results"]])
    check(r["ok"] == len(reqs) and max_rel(np, got, want)
          <= RTOL_CARD_VS_CPU,
          f"unsharded replay: {r['ok']} of {len(reqs)} requests answered "
          f"over HTTP (max rel diff {max_rel(np, got, want):.3e})")
    rep["http_unsharded"] = {k: r[k] for k in (
        "ok", "wall_s", "client_p50_ms", "client_p99_ms", "requests_per_s")}
    print(f"unsharded replay over HTTP: p50 {r['client_p50_ms']:.3f} ms, "
          f"p99 {r['client_p99_ms']:.3f} ms, {r['requests_per_s']:.1f} "
          f"req/s, {len(reqs)} requests, 8 clients; card: {card}")

    # -- two TCP shard workers on the card behind HTTP ---------------------
    mib_before = gpu_memory_used_mib()
    t0 = time.perf_counter()
    pool = launch_tcp_workers(2, device="cuda")
    plane = bg = None
    try:
        plane = ShardPlane(workers=0, mode="thread", remote=pool.addresses)
        # no prediction cache: every replay executes on the plane
        svc = LatencyService(oracle, max_wave=64, cache_size=0,
                             shard_plane=plane,
                             supervise=LifecycleConfig(endpoints={
                                 i: (lambda i=i: pool.respawn(i))
                                 for i in range(2)}))
        boot_s = time.perf_counter() - t0
        check(svc._shard_gen is not None and not svc.stats.degraded
              and svc.supervisor is not None,
              f"2 TCP shard workers loaded the bank on the card "
              f"({boot_s:.1f} s with their start; "
              f"{svc.stats.degraded_reason})")
        bg = BackgroundServer(svc, host="127.0.0.1", port=0).start()

        def http_run(tag, stats=True, **kw):
            """One replay of ``reqs`` over HTTP; with ``stats``, each
            worker's fused launches during it (from the worker process)."""
            st0 = [w.stats() for w in plane.workers] if stats else []
            s0 = plane.slices
            r = replay(bg.host, bg.port, reqs, clients=8, **kw)
            st1 = [w.stats() for w in plane.workers] if stats else []
            got = np.array([x["latency_ms"] if x else np.nan
                            for x in r["results"]])
            check(r["ok"] == len(reqs) and not r["errors"],
                  f"{tag}: {r['ok']} of {len(reqs)} requests answered over "
                  f"HTTP ({len(r['errors'])} errors)")
            rel = max_rel(np, got, want)
            check(rel <= RTOL_CARD_VS_CPU,
                  f"{tag}: answers as the unsharded service (max rel diff "
                  f"{rel:.3e})")
            out = {"ok": r["ok"], "wall_s": r["wall_s"],
                   "client_p50_ms": r["client_p50_ms"],
                   "client_p99_ms": r["client_p99_ms"],
                   "requests_per_s": r["requests_per_s"], "max_rel": rel,
                   "slices": plane.slices - s0,
                   "worker_launches": [
                       b["launches"]["predict_grouped"]
                       - a["launches"]["predict_grouped"]
                       for a, b in zip(st0, st1)],
                   "worker_pids": [b["pid"] for b in st1],
                   "worker_stats": st1}
            print(f"{tag} over HTTP: p50 {out['client_p50_ms']:.3f} ms, "
                  f"p99 {out['client_p99_ms']:.3f} ms, "
                  f"{out['requests_per_s']:.1f} req/s, "
                  f"{len(reqs)} requests, 8 clients; card: {card}")
            return out

        first = http_run("sharded replay")
        check(sum(first["worker_launches"]) == first["slices"] > 0
              and all(n > 0 for n in first["worker_launches"]),
              f"the workers ran one fused grouped launch per slice on the "
              f"card ({first['worker_launches']} for {first['slices']} "
              "slices)")
        first["contexts"] = check_worker_contexts(
            "sharded replay", pool.procs, first.pop("worker_stats"),
            mib_before, card)

        # kill worker 1 while a replay is in flight; the supervisor
        # respawns it and every request still answers (retried once)
        old_pid = pool.procs[1].pid
        base = svc.stats.requests
        errs0, fb0 = svc.stats.shard_slice_errors, plane.fallback_rows
        result = {}

        def run():
            result["r"] = http_run("replay with a worker killed",
                                   stats=False, retry=RetryPolicy(
                                       max_attempts=4, base_s=0.05,
                                       retry_statuses=frozenset({500})))
        t = threading.Thread(target=run)
        t.start()
        deadline = time.time() + 60
        while svc.stats.requests < base + len(reqs) // 5 \
                and time.time() < deadline:
            time.sleep(0.001)
        in_flight = t.is_alive()
        pool.kill(1)
        t.join(timeout=300)
        check(in_flight and not t.is_alive() and "r" in result,
              f"worker 1 (pid {old_pid}) killed while the replay was in "
              f"flight ({svc.stats.requests - base} requests in)")
        deadline = time.time() + 120
        while plane.adoptions < 1 and time.time() < deadline:
            time.sleep(0.05)
        check(plane.adoptions >= 1 and plane.alive_workers() == 2
              and pool.procs[1].pid != old_pid,
              f"the supervisor respawned worker 1 as pid "
              f"{pool.procs[1].pid} ({plane.adoptions} adoption)")
        killed = result["r"]
        killed.update(slice_errors=svc.stats.shard_slice_errors - errs0,
                      fallback_rows=plane.fallback_rows - fb0)
        check(killed["slices"] > 0 and killed["fallback_rows"] > 0,
              f"waves after the kill rode the live worker and the parent "
              f"answered the dead one's rows ({killed['slices']} slices, "
              f"{killed['fallback_rows']} fallback rows, "
              f"{killed['slice_errors']} slice errors retried)")
        after = http_run("replay after the respawn")
        check(all(n > 0 for n in after["worker_launches"]),
              f"the respawned worker serves its slices on the card "
              f"({after['worker_launches']})")
        after["contexts"] = check_worker_contexts(
            "after the respawn", pool.procs, after.pop("worker_stats"),
            mib_before, card)
        rep["http"] = {"sharded": first, "killed": killed,
                       "after_respawn": after,
                       "lifecycle": plane.summary().get("lifecycle")}
    finally:
        if bg is not None:
            bg.stop()
        if plane is not None:
            plane.close()
        pool.close()

    # -- float64-only members: every plane kind bit for bit ----------------
    from repro_torch.api.oracle import LatencyOracle
    o64 = LatencyOracle.fit(oracle.dataset, ProfetConfig(
        members=("linear", "forest"), n_trees=60, seed=args.seed),
        device="cuda")
    Xb = np.concatenate([w[0] for w in waves])
    gb = np.concatenate([w[1] for w in waves])
    want64 = o64.bank.execute(Xb, gb)
    pool = launch_tcp_workers(2, device="cuda")
    try:
        for kind, kw in (("thread", dict(workers=2, mode="thread")),
                         ("spawn", dict(workers=2, mode="spawn")),
                         ("tcp", dict(workers=0, mode="thread",
                                      remote=pool.addresses))):
            with ShardPlane(**kw) as p64:
                got = p64.load(o64.bank).execute(Xb, gb)
                check(np.array_equal(got, want64) and p64.slices == 2,
                      f"float64 members, {kind} plane on the card: "
                      f"{len(Xb)} rows bit for bit as the unsharded bank")
    finally:
        pool.close()
    rep["float64_planes_rows"] = len(Xb)
    return rep


# ---------------------------------------------------------------------------
# live calibration (phase 11) and the paper's baselines (phase 12)
# ---------------------------------------------------------------------------

# serve_calibrated's defaults: the drift-injection replay and the control
# loop's configuration
CAL_ROUNDS, CAL_REQUESTS, CAL_CLIENTS, CAL_WAVE = 6, 120, 4, 32
CAL_DRIFT, CAL_ONSET, CAL_NOISE, CAL_INTERVAL = 1.6, 1, 0.01, 0.05
CAL_TRIGGER = 10.0
# past the reference's 6 rounds the replay goes on until the promotion and
# CAL_AFTER rounds after it, at most CAL_MAX_ROUNDS in all: on the paper
# grid the drifted pair gets ~6 measured requests a round, and the refit
# waits for 24 of them scored after the drift was detected
CAL_AFTER, CAL_MAX_ROUNDS = 2, 20
# MLPredict on the card against its CPU fit: the percentage-point band of
# tests/test_torch_fit_mape.py, here two-sided, per target device
MLPREDICT_BAND_PTS = 3.0


def round_kind(rec, onset, spans, promoted_at) -> str:
    """What the calibrator had in flight during one replay round: the
    kinds of work whose span overlaps the round's, or its phase."""
    busy = sorted({kind for kind, t0, t1 in spans
                   if t0 < rec["t1"] and t1 > rec["t0"]})
    if busy:
        return "+".join(busy)
    if rec["round"] < onset:
        return "before drift"
    if promoted_at is not None and rec["t0"] >= promoted_at:
        return "after promotion"
    return "drift, nothing in flight"


def calibration_phase(torch, np, oracle, waves, args, card) -> dict:
    """Phase 11: ``serve_calibrated``'s drift-injection replay on the card
    over the phase-1 oracle, then the recovery and a refit on the card
    and on the CPU."""
    import shutil

    from repro_torch.api.artifacts import CalibrationStore
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.calibrate import (CalibrationConfig, Calibrator,
                                       build_candidate, heldout_scores)
    from repro_torch.calibrate import canary as canary_mod
    from repro_torch.convert import profet_from_numpy, profet_to_numpy
    from repro_torch.kernels import forest_eval
    from repro_torch.launch.serve_calibrated import DriftTruth, replay_round
    from repro_torch.serve import BackgroundServer, LatencyService

    X, gids = max(waves, key=lambda w: len(w[0]))
    store_dir = ROOT / "build" / "smoke" / "calibration"
    shutil.rmtree(store_dir, ignore_errors=True)
    store = CalibrationStore(store_dir)
    cfg = CalibrationConfig(trigger_mape=CAL_TRIGGER, min_obs=8,
                            min_refit_obs=6, canary_min_obs=4,
                            confirm_obs=16, cooldown_scored=16)
    spans, swaps = [], []       # (kind, t0, t1); the promoted oracles

    def timed(kind, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((kind, t0, time.perf_counter()))
        return run

    svc = LatencyService(oracle, max_wave=CAL_WAVE)
    base_epoch = svc.epoch
    refreshed = svc.oracle_refreshed

    def swap(new, label=None):
        warm0 = svc.stats.warmup_ms
        epoch = refreshed(new, label)
        swaps.append({"oracle": new, "epoch": epoch,
                      "warmup_ms": svc.stats.warmup_ms - warm0,
                      "launches_at_swap": new.bank.forest_launches})
        return epoch

    svc.oracle_refreshed = timed("swap", swap)
    verdict = canary_mod.verdict
    canary_mod.verdict = timed("canary", verdict)
    cal = Calibrator(svc, cfg, store=store,
                     refit_fn=timed("refit", build_candidate))
    truth = DriftTruth(oracle.dataset, oracle.pairs()[0], CAL_DRIFT,
                       CAL_NOISE, seed=args.seed)
    pair = truth.pair
    rounds = []
    bg = None
    forest_eval.reset_launches()
    incumbent0 = oracle.bank.forest_launches
    try:
        cal.start(interval=CAL_INTERVAL)
        bg = BackgroundServer(svc, host="127.0.0.1", port=0,
                              calibrator=cal).start()
        print(f"calibration replay: {truth.label} x{CAL_DRIFT} from round "
              f"{CAL_ONSET}, trigger MAPE {CAL_TRIGGER}, epoch {base_epoch}")
        promoted_round = None
        for rnd in range(CAL_MAX_ROUNDS):
            t0 = time.perf_counter()
            rec = replay_round(bg, cal, oracle, truth, rnd, onset=CAL_ONSET,
                               requests=CAL_REQUESTS, clients=CAL_CLIENTS,
                               interval=CAL_INTERVAL, seed=args.seed)
            rec.update(t0=t0, t1=time.perf_counter())
            rounds.append(rec)
            if cal.stats.promotions and promoted_round is None:
                promoted_round = rnd
            if rnd + 1 >= CAL_ROUNDS and promoted_round is not None \
                    and rnd - promoted_round >= CAL_AFTER \
                    and cal.detector.samples(pair) >= cfg.min_obs:
                break
        cal.stop()
    finally:
        cal.stop()
        if bg is not None:
            bg.stop()
        canary_mod.verdict = verdict
    launches = dict(forest_eval.launches)
    plain = dict(forest_eval.plain_calls)
    incumbent = oracle.bank.forest_launches - incumbent0
    s = cal.summary()
    print("calibration timeline:")
    for ev in cal.stats.events:
        print(f"  * {ev}")
    promoted_at = min((t0 for kind, t0, _ in spans if kind == "swap"),
                      default=None)
    for rec in rounds:
        rec["kind"] = round_kind(rec, CAL_ONSET, spans, promoted_at)
        print(f"round {rec['round']} ({rec['kind']}; state {rec['state']}): "
              f"p50 {rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms, "
              f"{rec['requests_per_s']:.1f} req/s, {rec['ok']}/{rec['n']} "
              f"ok; card: {card}")
    by_kind = {}
    for rec in rounds:
        by_kind.setdefault(rec["kind"], []).append(rec)
    kinds = {k: {"rounds": [r["round"] for r in v],
                 "p50_ms": float(np.median([r["p50_ms"] for r in v])),
                 "p99_ms": float(np.median([r["p99_ms"] for r in v])),
                 "requests_per_s": float(np.median(
                     [r["requests_per_s"] for r in v]))}
             for k, v in by_kind.items()}
    for k, v in kinds.items():
        print(f"rounds {v['rounds']} ({k}): median p50 {v['p50_ms']:.3f} "
              f"ms, median p99 {v['p99_ms']:.3f} ms, median "
              f"{v['requests_per_s']:.1f} req/s")
    secs = {kind: [t1 - t0 for k, t0, t1 in spans if k == kind]
            for kind in ("refit", "canary", "swap")}
    print(f"refit s {secs['refit']}, canary s {secs['canary']}, swap ms "
          f"{[1e3 * t for t in secs['swap']]}, warm-up ms "
          f"{[w['warmup_ms'] for w in swaps]}; card: {card}")
    n_ok = sum(r["ok"] for r in rounds)
    n_req = sum(r["n"] for r in rounds)
    check(n_ok == n_req and not any(r["errors"] for r in rounds),
          f"calibration replay: {n_ok} of {n_req} requests answered over "
          f"{len(rounds)} rounds")
    check(s["drift_events"] >= 1 and s["refits"] >= 1
          and s["canary_pass"] >= 1 and s["promotions"] >= 1,
          f"drift detected ({s['drift_events']}), refit ({s['refits']}), "
          f"canary passed ({s['canary_pass']} of "
          f"{s['canary_pass'] + s['canary_fail']}) and promoted "
          f"({s['promotions']}; {s['rollbacks']} rollbacks) mid-traffic")
    mape = cal.detector.mape(pair)
    check("+cal" in svc.epoch and svc.epoch != base_epoch and swaps
          and svc.epoch == swaps[-1]["epoch"],
          f"the service serves the promoted epoch {svc.epoch}")
    check(cal.detector.samples(pair) >= cfg.min_obs and mape < CAL_TRIGGER,
          f"{truth.label} rolling MAPE after the promotion {mape:.3f} < "
          f"{CAL_TRIGGER} over {cal.detector.samples(pair)} observations")
    promoted = swaps[-1]["oracle"]
    cand_launches = (promoted.bank.forest_launches
                     - swaps[-1]["launches_at_swap"])
    # the calibrated path's fused grouped launches by whose bank ran them:
    # the incumbent's (waves before the swap, scoring, the canary), the
    # candidate's before the swap (canary, shadow waves) and after it
    # (served waves, scoring); the rest are the swap's bank warm-up
    split = {"incumbent": incumbent,
             "candidate_before_swap": swaps[-1]["launches_at_swap"],
             "candidate_after_swap": cand_launches}
    split["warmup"] = launches["predict_grouped"] - sum(split.values())
    check(cand_launches > 0 and launches["predict_grouped"] > 0
          and promoted.bank.device.type == "cuda",
          f"the promoted candidate's bank served {cand_launches} fused "
          f"grouped launches on the card ({launches['predict_grouped']} "
          f"on the calibrated path in all: {json.dumps(split)})")
    check(not any(plain.values()),
          f"no plain forest call on the calibrated path "
          f"({json.dumps(plain)})")
    print(f"launches on the calibrated path: {json.dumps(launches)}; plain "
          f"calls {json.dumps(plain)}")

    # -- recovery on the card and on the CPU ------------------------------
    want = member_preds(torch, promoted.bank, X, gids)
    recovered = {}
    for dev in ("cuda", "cpu"):
        got = store.recover(expect_config=oracle.config, device=dev)
        check(got is not None and got[1] == svc.epoch,
              f"CalibrationStore.recover on {dev} gives the promoted epoch "
              f"({got[1] if got else None})")
        preds = member_preds(torch, got[0].bank, X, gids)
        for member in ("linear", "forest"):
            check(np.array_equal(preds[member], want[member]),
                  f"recovered on {dev}: the {member} member equals the "
                  f"promoted one's bit for bit ({len(X)} rows)")
        recovered[dev] = got[1]

    # -- the same refit on the card and on the CPU ------------------------
    cpu_oracle = LatencyOracle(profet_from_numpy(
        profet_to_numpy(oracle.profet), device="cpu"), oracle.dataset)
    refit = {}
    for dev, orc in (("cuda", oracle), ("cpu", cpu_oracle)):
        t0 = time.perf_counter()
        cand, rep = build_candidate(orc, cal.buffer, [pair],
                                    min_refit_obs=cfg.min_refit_obs,
                                    window=cfg.drift_confirm_obs)
        fit_s = time.perf_counter() - t0
        check(cand is not None and rep.pairs == (pair,)
              and cand.ensemble(*pair).device.type == dev,
              f"build_candidate on {dev}: {rep.pairs}, {rep.total_obs} obs, "
              f"fit on {dev} in {fit_s:.2f} s")
        scores = heldout_scores(orc, cand, cal.buffer, pairs=[pair],
                                min_obs=cfg.canary_min_obs,
                                window=cfg.drift_confirm_obs)
        inc, cmape, n = scores.get(pair, (np.nan, np.nan, 0))
        check(cmape < CAL_TRIGGER,
              f"{dev} candidate's held-out MAPE on {truth.label} "
              f"{cmape:.3f} < {CAL_TRIGGER} (incumbent {inc:.3f}, {n} obs)")
        refit[dev] = {"cand": cand, "fit_s": fit_s, "heldout": cmape,
                      "incumbent": inc, "n_obs": n, "scale": rep.scale[pair]}
    card_m = member_preds(torch, refit["cuda"]["cand"].bank, X, gids)
    cpu_m = member_preds(torch, refit["cpu"]["cand"].bank, X, gids)
    for member in ("linear", "forest"):
        check(np.array_equal(card_m[member], cpu_m[member]),
              f"refit candidate's {member} member: card and CPU bit for "
              f"bit ({len(X)} rows)")
    dnn_rel = max_rel(np, card_m["dnn"], cpu_m["dnn"])
    print(f"refit candidate's DNN member, card against CPU: max rel diff "
          f"{dnn_rel:.3e} (float32, trained on each device)")
    for r in refit.values():
        del r["cand"]
    return {"rounds": [{k: v for k, v in r.items() if k not in ("t0", "t1")}
                       for r in rounds],
            "by_kind": kinds, "refit_s": secs["refit"],
            "canary_s": secs["canary"],
            "swap_ms": [1e3 * t for t in secs["swap"]],
            "warmup_ms": [w["warmup_ms"] for w in swaps],
            "launches": launches, "plain_calls": plain,
            "candidate_fused_launches": cand_launches,
            "fused_launches_by_bank": split,
            "summary": {k: s[k] for k in (
                "drift_events", "refits", "canary_pass", "canary_fail",
                "promotions", "rollbacks", "confirms", "scored",
                "shadow_waves", "persisted")},
            "epoch": svc.epoch, "mape_after": mape, "recovered": recovered,
            "refit": refit, "refit_dnn_card_vs_cpu_max_rel": dnn_rel}


def baselines_phase(np, card) -> dict:
    """Phase 12: MLPredict fitted on the card and on the CPU, Paleo and
    Habitat on the host, all on the paper grid's train/test split
    (``benchmarks/common.split``: 20% held out, seed 0)."""
    from repro_torch.core import baselines, workloads
    from repro_torch.core.ensemble import mape

    ds = workloads.generate()
    train, test = workloads.split_cases(ds.cases, test_frac=0.2, seed=0)
    true = {d: np.array([ds.latency(d, c) for c in test])
            for d in ds.devices}
    ml = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = baselines.MLPredictModel(epochs=300, seed=0, device=dev).fit(
            ds, train)
        fit_s = time.perf_counter() - t0
        check(m.reg.params[0]["w"].device.type == dev,
              f"MLPredict fitted on {dev} in {fit_s:.1f} s")
        per = {d: mape(true[d], [m.predict(d, c) for c in test])
               for d in ds.devices}
        check(all(np.isfinite(v) for v in per.values()),
              f"MLPredict on {dev}: finite held-out MAPE per target")
        ml[dev] = {"fit_s": fit_s, "mape": per}
    for d in ds.devices:
        a, b = ml["cuda"]["mape"][d], ml["cpu"]["mape"][d]
        check(abs(a - b) <= MLPREDICT_BAND_PTS,
              f"MLPredict MAPE on {d}: card {a:.3f}, CPU {b:.3f} (within "
              f"{MLPREDICT_BAND_PTS} points); card: {card}")
    pa = baselines.PaleoModel()
    for d in ds.devices:
        pa.calibrate_many(d, train, [ds.latency(d, c) for c in train])
    paleo = {d: mape(true[d], [pa.predict(d, c) for c in test])
             for d in ds.devices}
    hb = baselines.HabitatScaling()
    habitat = {f"{a}->{t}": mape(true[t], [hb.predict(a, t, c)
                                           for c in test])
               for a in ds.devices for t in ds.devices if a != t}
    print(f"held-out MAPE, {len(test)} cases per device: Paleo "
          f"{json.dumps(paleo)}; Habitat {json.dumps(habitat)}")
    return {"mlpredict": ml, "paleo": paleo, "habitat": habitat,
            "n_test": len(test)}


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------


def median_ms(torch, fn, calls=5):
    """Median time of one ``fn()`` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[calls // 2]


def flash_work(q, k):
    """(bytes, operations) of causal attention: q, k, v read once and the
    output written once; 4 D operations for each (query, key <= query)
    pair of a head (q.k and p.v)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * q.element_size()
    return nbytes, 4 * D * B * H * S * (S + 1) // 2


def ssd_work(X, Bc, chunk):
    """(bytes, operations) of the chunked SSD scan: X, Adt (f32), Bc, Cc
    read once and Y written once; per (b, h, chunk) C.B^T (2 N) and
    scores.X (2 P) for each (position, position j <= it) pair of the chunk,
    as ``flash_work`` counts only the causal pairs, plus C.S^T and the
    state update (2 Q N P each)."""
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * X.element_size() \
        + B * S * H * 4
    per_chunk = chunk * (chunk + 1) * (N + P) + 4 * chunk * N * P
    return nbytes, B * H * (S // chunk) * per_chunk


def lm_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    return {**fa_mod.launches, **ssd_mod.launches}


def lm_reset_launches() -> None:
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    fa_mod.reset_launches()
    ssd_mod.reset_launches()


def lm_prefill(torch, np, arch, kernel, args, dev) -> dict:
    """Phases 6 and 7: one model's prefill step at full width on (4, 2048)
    tokens. Returns the model, its config, the kernel's inputs on the main
    path and the phase's report."""
    from repro_torch.configs import base as CB
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = CB.get_config(arch)
    t0 = time.perf_counter()
    model32 = M.init(cfg, seed=args.seed, device=dev)
    # round the float32 params to bf16 values in place, so that the float32
    # plain run below computes the served bf16 model's function in float32
    with torch.no_grad():
        for t in model32.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model32.parameters())
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_SEQ))).to(dev)
    batch = {"tokens": tokens}
    pv = L.padded_vocab(cfg.vocab_size)

    # the model through the kernel against the plain version, in float32
    # end to end, at the CPU parity tests' float32 bar
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    last32 = M.forward(model32, cfg32, batch)[0][:, -1]
    plain32 = M.forward(model32, cfg32, batch, backend="torch")[0][:, -1]
    err32 = float((last32 - plain32).abs().max())
    check(bool(torch.allclose(last32, plain32, atol=1e-4, rtol=1e-4)),
          f"{arch} float32 last-position logits through the {kernel} kernel "
          f"equal the plain version's within atol 1e-4 rtol 1e-4 (max abs "
          f"diff {err32:.3e}, max |logit| {float(plain32.abs().max()):.3f})")
    del last32

    # the main path: bf16 params, as the prefill step is served
    model = M.cast(model32, cfg, torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    step = make_prefill_step(cfg)

    # record the kernel's inputs of the first block on the main path
    mod = fa_mod if kernel == "flash_attention" else ssd_mod
    launch = getattr(mod, kernel)
    seen = []

    def recording(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return launch(*a, **kw)

    setattr(mod, kernel, recording)
    lm_reset_launches()
    nxt = step(model, batch)
    torch.cuda.synchronize()
    counts = lm_launches()
    setattr(mod, kernel, launch)
    other = "ssd_scan" if kernel == "flash_attention" else "flash_attention"
    check(counts[kernel] == cfg.num_layers and counts[other] == 0,
          f"{arch} prefill: {counts[kernel]} {kernel} launches, one per "
          f"block ({cfg.num_layers}), and {counts[other]} {other}")
    check(tuple(nxt.shape) == (LM_BATCH, 1) and nxt.dtype == torch.int32
          and bool(((nxt >= 0) & (nxt < pv)).all()),
          f"{arch} prefill: ({LM_BATCH}, 1) int32 next tokens in [0, {pv})")

    # in bf16 the kernel's run and the plain run round differently after
    # every block; each is held against the float32 plain run of the same
    # (bf16-valued) params, and the kernel's run may stray from it at most
    # BF16_VS_PLAIN times as far as the plain run does
    last = M.forward(model, cfg, batch)[0][:, -1].float()
    plain = M.forward(model, cfg, batch, backend="torch")[0][:, -1].float()
    check(bool(torch.isfinite(last).all())
          and tuple(last.shape) == (LM_BATCH, pv),
          f"{arch} bf16 last-position logits finite, ({LM_BATCH}, {pv})")
    err = float((last - plain).abs().max())
    err_k = float((last - plain32).abs().max())
    err_p = float((plain - plain32).abs().max())
    same = int((last.argmax(-1) == plain.argmax(-1)).sum())
    print(f"{arch} bf16 logits against the plain {kernel}: max abs diff "
          f"{err:.3e}, max |logit| {float(plain.abs().max()):.3f}, "
          f"{same} of {LM_BATCH} next tokens equal")
    check(err_k <= BF16_VS_PLAIN * err_p,
          f"{arch} bf16 logits through the {kernel} kernel stray from the "
          f"float32 plain run {err_k:.3e}, within {BF16_VS_PLAIN} x the bf16 "
          f"plain run's {err_p:.3e}")
    del plain32

    lm_reset_launches()
    calls = 5
    ms = median_ms(torch, lambda: step(model, batch), calls=calls)
    check(lm_launches()[kernel] == cfg.num_layers * (calls + 1),
          f"{arch}: {cfg.num_layers} {kernel} launches per timed call")
    rep = {"params": n_params, "init_s": init_s, "launches": counts[kernel],
           "step_ms": ms, "tokens_per_s": LM_BATCH * LM_SEQ / ms * 1e3,
           "f32_logits_max_abs_diff_vs_plain": err32,
           "logits_max_abs_diff_vs_plain": err,
           "bf16_kernel_vs_f32_plain": err_k,
           "bf16_plain_vs_f32_plain": err_p,
           "next_token_equal_vs_plain": same,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{arch} prefill: {json.dumps(rep)}")
    return {"cfg": cfg, "model": model, "seen": seen[0], "report": rep,
            "step": step, "batch": batch}


def lm_serve(torch, np, arch, cfg, model, args) -> dict:
    """Phase 7: 8 requests through ``Engine`` (4 slots, 16 new tokens,
    max_len 128, continuous), prompts drawn as ``launch/serve.py`` does."""
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg, model, batch_slots=4, max_len=128)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(8):
        plen = int(rng.integers(2, 12))
        reqs.append(eng.submit(
            rng.integers(1, min(cfg.vocab_size, 1000), size=plen).tolist(),
            max_new_tokens=16))
    lm_reset_launches()
    eng.run()
    torch.cuda.synchronize()
    pv = L.padded_vocab(cfg.vocab_size)
    s = eng.stats
    check(all(r.done and len(r.output) == 16
              and all(0 <= t < pv for t in r.output) for r in reqs)
          and sum(lm_launches().values()) == 0,
          f"{arch} engine: 8 requests, 16 tokens each in [0, {pv}), no "
          f"kernel launched")
    rep = {"requests": len(reqs), "decode_steps": s.decode_steps,
           "prefill_tokens": s.prefill_tokens,
           "generated_tokens": s.generated_tokens, "wall_s": s.wall_s,
           "tokens_per_s": s.tokens_per_s,
           "beyond_vocab_tokens": sum(t >= cfg.vocab_size for r in reqs
                                      for t in r.output)}
    print(f"{arch} serve: {json.dumps(rep)}")
    return rep


def sass_hmma(name) -> int:
    """Tensor-core (``HMMA``) instructions in the SASS of the library built
    from ``csrc/<name>.cu``, read with the toolkit's ``cuobjdump``."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def lm_kernel_checks(torch, np, flash_in, ssd_in, dev) -> tuple:
    """Phase 8: each kernel against its plain version at the main path's
    inputs and at random shapes, bf16 launches repeatable bit for bit, and
    tensor-core instructions in the SASS. Returns (max abs error at the
    main path's inputs per kernel, the cases checked, HMMA counts)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    rng = np.random.default_rng(1)

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    def tol(dtype):
        return dict(atol=6e-3, rtol=3e-2) if dtype == torch.bfloat16 \
            else dict(atol=2e-5, rtol=1e-4)

    cases = []
    (q, k, v), _ = flash_in
    flash_sets = [("main path", q, k, v)]
    for B, S, H, KV, D, dt in [(2, 512, 32, 8, 64, torch.float32),
                               (2, 300, 8, 1, 128, torch.bfloat16),
                               (1, 1024, 16, 16, 128, torch.bfloat16),
                               (1, 300, 4, 2, 64, torch.float32),
                               (1, 1000, 8, 2, 16, torch.bfloat16),
                               (2, 300, 4, 4, 32, torch.bfloat16),
                               (1, 1000, 8, 1, 64, torch.bfloat16)]:
        flash_sets.append((f"{(B, S, H, KV, D)} {dt}".replace("torch.", ""),
                           randn((B, S, H, D), dt), randn((B, S, KV, D), dt),
                           randn((B, S, KV, D), dt)))
    errs = {}
    for name, q, k, v in flash_sets:
        got = fa_mod.flash_attention(q, k, v, backend="cuda").float()
        want = fa_mod.flash_attention(q, k, v, backend="torch").float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        errs.setdefault("flash_attention", e)
        ok = bool(torch.allclose(got, want, **tol(q.dtype)))
        cases.append({"kernel": "flash_attention", "case": name,
                      "max_abs_err": e, "ok": ok})
        check(ok, f"flash_attention kernel equals its plain version, "
              f"{name} (max abs err {e:.3e})")

    (X, Adt, Bc, Cc), kw = ssd_in
    ssd_sets = [("main path", X, Adt, Bc, Cc, kw["chunk"])]
    for B, S, H, P, N, dt, chunk in [
            (2, 512, 8, 64, 128, torch.float32, 64),
            (1, 1024, 4, 64, 128, torch.bfloat16, 256),
            (1, 192, 2, 32, 64, torch.float32, 64),
            (1, 512, 4, 32, 64, torch.bfloat16, 64),
            (2, 512, 2, 128, 128, torch.bfloat16, 128),
            (1, 4096, 2, 64, 128, torch.bfloat16, 256),
            (1, 4096, 1, 128, 64, torch.bfloat16, 256)]:
        ssd_sets.append((
            f"{(B, S, H, P, N)} {dt} chunk {chunk}".replace("torch.", ""),
            randn((B, S, H, P), dt),
            -torch.nn.functional.softplus(randn((B, S, H), torch.float32))
            * 0.5, randn((B, S, N), dt), randn((B, S, N), dt), chunk))
    for name, X, Adt, Bc, Cc, chunk in ssd_sets:
        got = ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                               backend="cuda").float()
        want = ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                                backend="torch").float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        errs.setdefault("ssd_scan", e)
        scale = float(want.abs().max())
        ok = bool(torch.allclose(got / scale, want / scale, **tol(X.dtype)))
        cases.append({"kernel": "ssd_scan", "case": name, "max_abs_err": e,
                      "max_abs_ref": scale, "ok": ok})
        check(ok, f"ssd_scan kernel equals its plain version, {name} (max "
              f"abs err {e:.3e}, max |ref| {scale:.3f})")

    # no atomics and a fixed order of every sum: the same bits twice
    (q, k, v), _ = flash_in
    check(torch.equal(fa_mod.flash_attention(q, k, v, backend="cuda"),
                      fa_mod.flash_attention(q, k, v, backend="cuda")),
          "flash_attention: two bf16 launches at the main path's inputs "
          "give the same bits")
    (X, Adt, Bc, Cc), kw = ssd_in
    check(torch.equal(
        ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"], backend="cuda"),
        ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"], backend="cuda")),
        "ssd_scan: two bf16 launches at the main path's inputs give the "
        "same bits")

    hmma = {n: sass_hmma(n) for n in ("flash_attention", "ssd_scan")}
    for n, count in hmma.items():
        check(count > 0, f"{n}.cu SASS holds {count} HMMA (tensor-core) "
              f"instructions")
    return errs, cases, hmma


def lm_kernel_rows(torch, flash_in, ssd_in, counts, errs, tag="") -> list:
    """The LM kernels' lines: times at the main path's inputs beside their
    bounds (at the peak of the inputs' dtype), their plain versions' times
    and SDPA's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    (q, k, v), _ = flash_in
    (X, Adt, Bc, Cc), kw = ssd_in
    chunk = kw["chunk"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows = []
    for name, kern, plain, lib, work, replaces in [
        ("flash_attention",
         lambda: fa_mod.flash_attention(q, k, v, backend="cuda"),
         lambda: fa_mod.flash_attention(q, k, v, backend="torch"),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True),
         flash_work(q, k), "src/repro/kernels/flash_attention.py:74"),
        ("ssd_scan",
         lambda: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                                  backend="cuda"),
         lambda: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=chunk,
                                  backend="torch"),
         None, ssd_work(X, Bc, chunk), "src/repro/kernels/ssd_scan.py:70"),
    ]:
        b_ms, b_by = bound_ms(*work, ops_per_s=(
            BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S))
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": time_kernel_ms(torch, kern, iters=10),
            "plain_ms": time_plain_ms(torch, plain, iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (time_kernel_ms(torch, lib, iters=20)
                           if lib is not None else None)})
        print(f"{name}{tag}: {json.dumps(rows[-1])} (bytes {work[0]}, "
              f"operations {work[1]})")
    return rows


def lm_f32_rows(torch, flash_in, ssd_in) -> list:
    """The float32 route (CUDA-core kernels) at the main path's shapes: the
    same inputs cast to float32, held against the plain versions at the
    float32 bar, and lines as ``lm_kernel_rows`` makes them (no launch on
    the main path, which is bf16)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    (q, k, v), _ = flash_in
    (X, Adt, Bc, Cc), kw = ssd_in
    q, k, v, X, Bc, Cc = (t.float() for t in (q, k, v, X, Bc, Cc))
    errs = {}
    for name, run, scale in [
            ("flash_attention",
             lambda b: fa_mod.flash_attention(q, k, v, backend=b), False),
            ("ssd_scan",
             lambda b: ssd_mod.ssd_scan(X, Adt, Bc, Cc, chunk=kw["chunk"],
                                        backend=b), True)]:
        got, want = run("cuda"), run("torch")
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        div = float(want.abs().max()) if scale else 1.0
        check(bool(torch.allclose(got / div, want / div, atol=2e-5,
                                  rtol=1e-4)),
              f"{name} float32 kernel equals its plain version at the main "
              f"path's shapes (max abs err {errs[name]:.3e})")
    return lm_kernel_rows(torch, ((q, k, v), {}), ((X, Adt, Bc, Cc), kw),
                          {"flash_attention": 0, "ssd_scan": 0}, errs,
                          tag=" (float32)")


def lm_phases(torch, np, args, dev, report) -> list:
    """Phases 6 to 10; returns the LM kernels' lines."""
    runs = {}
    for arch, kernel in (("llama3.2-1b", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        runs[kernel] = lm_prefill(torch, np, arch, kernel, args, dev)
    counts = {k: r["report"]["launches"] for k, r in runs.items()}
    report["lm_prefill"] = {k: r["report"] for k, r in runs.items()}
    report["lm_serve"] = {k: lm_serve(torch, np, r["cfg"].name, r["cfg"],
                                      r["model"], args)
                          for k, r in runs.items()}
    errs, cases, hmma = lm_kernel_checks(
        torch, np, runs["flash_attention"]["seen"], runs["ssd_scan"]["seen"],
        dev)
    report["lm_kernel_cases"] = cases
    report["sass_hmma"] = hmma
    rows = lm_kernel_rows(torch, runs["flash_attention"]["seen"],
                          runs["ssd_scan"]["seen"], counts, errs)
    report["lm_f32_kernels"] = lm_f32_rows(
        torch, runs["flash_attention"]["seen"], runs["ssd_scan"]["seen"])
    report["lm_trace"] = {}
    for k, r in runs.items():
        tr = traced(torch, lambda: r["step"](r["model"], r["batch"]))
        report["lm_trace"][k] = tr
        print(f"{r['cfg'].name} traced prefill: {json.dumps(tr)}")
    return rows


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
    from repro_torch.kernels import _build, forest_eval
    from repro_torch.serve import LatencyService, synthetic_requests

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in "
          f"{report['build_s']:.1f} s")

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
    replays, replay_counts = [], []
    for replay in (1, 2):
        before = dict(forest_eval.launches)
        replays.append(replay_once(svc, reqs))
        replay_counts.append({k: v - before[k]
                              for k, v in forest_eval.launches.items()})
        print(f"replay {replay}: {json.dumps(replays[-1])}; launches "
              f"{json.dumps(replay_counts[-1])}")
    per_group = oracle.execute(wave_plans, banked=False)
    counts = dict(forest_eval.launches)
    bank.execute = execute
    report["replays"] = replays
    report["replay_launches"] = replay_counts

    s = svc.stats
    check(s.requests == 2 * args.requests and s.errors == 0
          and all(r["requests"] == args.requests for r in replays),
          f"{s.requests} requests served, {s.errors} errors")
    check(not s.degraded and oracle.bank_error is None,
          "no degraded state and no bank error after serving")
    check(bank.forest_launches == s.fused_calls == len(waves) > 0,
          f"one grouped forest launch per banked wave "
          f"({bank.forest_launches} launches, {s.fused_calls} banked waves)")
    for replay, (r, c) in enumerate(zip(replays, replay_counts), 1):
        check(c["predict_grouped"] == r["banked_waves"]
              and c["leaf_values_grouped"] == c["tree_mean"] == 0
              and c["leaf_values_grouped/global"] == 0,
              f"replay {replay}: one fused grouped launch (traversal and "
              f"tree mean) per banked wave, by the shared route "
              f"({c['predict_grouped']} for {r['banked_waves']} waves; "
              f"leaves-only {c['leaf_values_grouped']}, global "
              f"{c['leaf_values_grouped/global']}, tree mean "
              f"{c['tree_mean']})")
    check(counts["predict_grouped"] == len(waves),
          f"{counts['predict_grouped']} fused grouped launches for "
          f"{len(waves)} banked waves")
    check(not per_group.banked and counts["predict"]
          == per_group.fused_calls > 0 and counts["leaf_values"] == 0
          and counts["leaf_values/global"] == 0,
          f"per-group wave: one fused single-forest launch per pair, by "
          f"the shared route ({counts['predict']} launches for "
          f"{per_group.fused_calls} pairs)")
    check(counts["tree_mean"] == 0,
          f"no separate tree-mean launch on the served path "
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
    D = X.shape[1]

    def chosen(grouped_, n, mean=False):
        """The plan the wrapper takes for n rows, or None (global route);
        with mean, the fused prediction's."""
        return forest_eval.route_plan(
            G if grouped_ else 1, T, N, n, D,
            lambda smem: forest_eval.resident_blocks(grouped_, smem, dev,
                                                     mean=mean))

    plans = {"grouped": chosen(True, m), "single": chosen(False, Xs.shape[0]),
             "predict_grouped": chosen(True, m, mean=True),
             "predict": chosen(False, Xs.shape[0], mean=True)}
    shown = {k: (tuple(p), forest_eval.resident_blocks(
                 k in ("grouped", "predict_grouped"), p.smem, dev,
                 mean=k.startswith("predict")))
             for k, p in plans.items() if p is not None}
    check(len(shown) == 4,
          f"the serving shapes take the shared route (R rows a tile, B a "
          f"batch, smem bytes; blocks resident on the card): {shown}")

    def max_err(a, b):
        """Max abs difference; NaN must meet NaN (else inf)."""
        if not a.numel():
            return 0.0
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        return float((a.nan_to_num() - b.nan_to_num()).abs().max())

    def grouped(backend, x=X, g=gid, args=fa, depth=f["depth"], route=None):
        """By the wrapper (route None), or by one route whatever the
        shape."""
        if route is None:
            return forest_eval.leaf_values_grouped(x, g, *args, depth,
                                                   backend=backend)
        if route == "global":
            return forest_eval._leaf_values_grouped_global(x, g, *args,
                                                           depth)
        plan = forest_eval.tile_plan(args[0].shape[0], *args[0].shape[1:],
                                     *x.shape)
        return forest_eval._leaf_values_grouped_shared(x, g, *args, depth,
                                                       plan)

    def single(backend, x=Xs, args=sa, depth=depth1, route=None):
        if route is None:
            return forest_eval.leaf_values(x, *args, depth=depth,
                                           backend=backend)
        if route == "global":
            return forest_eval._leaf_values_global(x, *args, depth=depth)
        plan = forest_eval.tile_plan(1, *args[0].shape, *x.shape)
        return forest_eval._leaf_values_shared(x, *args, depth=depth,
                                               plan=plan)

    def fused_grouped(backend, x=X, g=gid, args=fa, depth=f["depth"],
                      route=None):
        """The grouped prediction by the wrapper (route None), or forced
        through the fused kernel ("shared") whatever the shape."""
        if route is None:
            return forest_eval.predict_grouped(x, g, *args, depth,
                                               backend=backend)
        plan = forest_eval.tile_plan(args[0].shape[0], *args[0].shape[1:],
                                     *x.shape)
        return forest_eval._predict_grouped_shared(x, g, *args, depth, plan)

    def fused_single(backend, x=Xs, args=sa, depth=depth1, route=None):
        if route is None:
            return forest_eval.predict(x, *args, depth=depth,
                                       backend=backend)
        plan = forest_eval.tile_plan(1, *args[0].shape, *x.shape)
        return forest_eval._predict_shared(x, *args, depth=depth, plan=plan)

    # rows of every served wave, drawn with their group ids into a wave of
    # LARGE_WAVE rows spanning many row tiles
    X_all = torch.from_numpy(np.concatenate([w[0] for w in waves])).to(dev)
    g_all = torch.from_numpy(np.concatenate([w[1] for w in waves])).to(dev)
    pick = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, X_all.shape[0], size=LARGE_WAVE)).to(dev)
    X4k, g4k = X_all[pick].contiguous(), g_all[pick].contiguous()
    bad = gid.clone()
    bad[::5] = -1
    bad[2::7] = G
    bad[3::11] = G + 9
    kept = gid % 3 == 0
    kept_groups = sorted(set(gid[kept].tolist()))
    grouped_cases = [
        ("served wave", X, gid, fa, f["depth"]),
        ("random ragged stack", Xr, gr, ra, rnd["depth"]),
        ("out-of-range gids", X, bad, fa, f["depth"]),
        (f"only groups {kept_groups} of {G}", X[kept].contiguous(),
         gid[kept].contiguous(), fa, f["depth"]),
        ("m = 1", X[:1], gid[:1], fa, f["depth"]),
        (f"m = {LARGE_WAVE}", X4k, g4k, fa, f["depth"]),
    ]
    single_cases = [("served pair's rows", Xs, sa, depth1)] + [
        (f"random forest {g} (depth {int(rnd['depth'][g])})", Xr,
         tuple(a[g] for a in ra), int(rnd["depth"][g])) for g in range(4)] + [
        ("m = 1", Xs[:1], sa, depth1),
        (f"m = {LARGE_WAVE}", X4k, sa, depth1)]
    errs = {}
    runners = {"leaf_values_grouped": grouped, "leaf_values": single,
               "predict_grouped": fused_grouped, "predict": fused_single}
    for name, suffix in (("leaf_values_grouped", ""),
                         ("leaf_values_grouped", "/global"),
                         ("leaf_values", ""), ("leaf_values", "/global"),
                         ("predict_grouped", ""), ("predict", "")):
        route = "global" if suffix else "shared"
        worst = 0.0
        for case in (single_cases if name in ("leaf_values", "predict")
                     else grouped_cases):
            run = runners[name]
            e = max_err(run("cuda", *case[1:], route=route),
                        run("torch", *case[1:]))
            torch.cuda.synchronize()
            check(e == 0.0, f"{name}{suffix} equals its plain version, "
                  f"{case[0]} ({case[1].shape[0]} rows; max abs err {e})")
            worst = max(worst, e)
        errs[name + suffix] = worst
    zero = all(not bool(b.any()) for b in forest_eval._COUNTERS.values())
    check(zero, "the fused kernels' tile counters are back at zero")

    leaves = grouped("cuda")
    cpu_leaves = forest_eval.leaf_values_grouped(
        X.cpu(), gid.cpu(), *(a.cpu() for a in fa), f["depth"].cpu())
    e = max_err(leaves.cpu(), cpu_leaves)
    check(e == 0.0, f"leaf_values_grouped on the card equals the plain "
          f"version on the CPU, served wave (max abs err {e})")
    errs["leaf_values_grouped"] = max(errs["leaf_values_grouped"], e)
    errs["tree_mean"] = max(
        max_err(forest_eval.tree_mean(leaves),
                forest_eval.tree_mean(leaves, backend="torch")),
        max_err(forest_eval.tree_mean(leaves).cpu(),
                forest_eval.tree_mean(cpu_leaves)))
    check(errs["tree_mean"] == 0.0, f"tree_mean kernel equals its plain "
          f"version (max abs err {errs['tree_mean']})")
    for name, on_card, on_cpu in [
            ("predict_grouped", fused_grouped("cuda"),
             forest_eval.predict_grouped(X.cpu(), gid.cpu(),
                                         *(a.cpu() for a in fa),
                                         f["depth"].cpu())),
            ("predict", fused_single("cuda"),
             forest_eval.predict(Xs.cpu(), *(a.cpu() for a in sa),
                                 depth=depth1))]:
        e = max_err(on_card.cpu(), on_cpu)
        check(e == 0.0, f"{name} on the card equals the plain version on "
              f"the CPU, served shapes (max abs err {e})")
        errs[name] = max(errs[name], e)

    def grouped_work(x, g):
        """(bytes, compares) of a grouped traversal: the path's reads, gid
        and each used group's depth bound in, the (T, rows) leaves out."""
        path, cmp = path_bytes(torch, forest_eval, x, g, *fa[:4], f["depth"])
        n = x.shape[0]
        return path + n * 8 + int(g.unique().numel()) * 8 + T * n * 8, cmp

    def single_work(x):
        path, cmp = path_bytes(
            torch, forest_eval, x,
            torch.zeros(x.shape[0], dtype=torch.int64, device=dev),
            *(a[None] for a in sa[:4]),
            torch.tensor([depth1], dtype=torch.int64, device=dev))
        return path + T * x.shape[0] * 8, cmp

    def fused_work(work_l, n):
        """The traversal's work with (n,) means out in place of the (T, n)
        leaves (the scratch is not counted), plus the mean's T n adds and n
        divides."""
        return work_l[0] - T * n * 8 + n * 8, work_l[1] + T * n + n

    work_g, work_s = grouped_work(X, gid), single_work(Xs)
    work = {
        "leaf_values_grouped": work_g, "leaf_values_grouped/global": work_g,
        "leaf_values": work_s, "leaf_values/global": work_s,
        "tree_mean": (T * m * 8 + m * 8, T * m + m),
        "predict_grouped": fused_work(work_g, m),
        "predict": fused_work(work_s, Xs.shape[0]),
    }
    timed = {
        "leaf_values_grouped": (lambda: grouped("cuda"),
                                lambda: grouped("torch")),
        "leaf_values_grouped/global": (lambda: grouped("cuda",
                                                       route="global"),
                                       lambda: grouped("torch")),
        "leaf_values": (lambda: single("cuda"), lambda: single("torch")),
        "leaf_values/global": (lambda: single("cuda", route="global"),
                               lambda: single("torch")),
        "tree_mean": (lambda: forest_eval.tree_mean(leaves),
                      lambda: forest_eval.tree_mean(leaves,
                                                    backend="torch")),
        "predict_grouped": (lambda: fused_grouped("cuda"),
                            lambda: fused_grouped("torch")),
        "predict": (lambda: fused_single("cuda"),
                    lambda: fused_single("torch")),
    }
    meta = {
        "leaf_values_grouped": "src/repro/kernels/forest_eval.py:217",
        "leaf_values_grouped/global": "src/repro/kernels/forest_eval.py:217",
        "leaf_values": "src/repro/kernels/forest_eval.py:158",
        "leaf_values/global": "src/repro/kernels/forest_eval.py:158",
        "tree_mean": "src/repro/kernels/forest_eval.py:38",
        "predict_grouped": "src/repro/kernels/forest_eval.py:217",
        "predict": "src/repro/kernels/forest_eval.py:158",
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
        note = (" (bound: inputs once and the (rows,) means out; the "
                "(T, rows) scratch of leaves is not counted)"
                if name.startswith("predict") else "")
        print(f"{name}: {json.dumps(kernels[-1])}{note}")
    report["work"] = {k: {"bytes": v[0], "ops": v[1]} for k, v in work.items()}

    # each fused prediction in turns (fused, two, two, fused) with the two
    # launches it replaces: the leaves-only traversal, then the tree mean
    fused_vs_two = {}
    for name, fused_run, leaves_run in [
            ("predict_grouped", lambda: fused_grouped("cuda"),
             lambda: grouped("cuda")),
            ("predict", lambda: fused_single("cuda"),
             lambda: single("cuda"))]:
        runs = {"fused": fused_run,
                "two": lambda r=leaves_run: forest_eval.tree_mean(r())}
        t = [time_kernel_ms(torch, runs[k])
             for k in ("fused", "two", "two", "fused")]
        fu, tw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        fused_vs_two[name] = {"fused_ms": fu, "two_launches_ms": tw,
                              "fused_over_two": fu / tw, "turns_ms": t}
        print(f"{name} fused against its two launches: "
              f"{json.dumps(fused_vs_two[name])}")
    report["fused_vs_two_launches"] = fused_vs_two

    # both routes at larger waves, over the bank and through one forest,
    # and the one the wrapper takes there
    large = {"leaf_values_grouped": {}, "leaf_values": {}}
    for n in WAVE_SIZES:
        xn, gn = X4k[:n].contiguous(), g4k[:n].contiguous()
        for name, work_l, runs, grouped_ in [
                ("leaf_values_grouped", grouped_work(xn, gn),
                 {r: (lambda r=r: grouped("cuda", xn, gn, route=r))
                  for r in ROUTES}, True),
                ("leaf_values", single_work(xn),
                 {r: (lambda r=r: single("cuda", xn, route=r))
                  for r in ROUTES}, False)]:
            b_ms, b_by = bound_ms(*work_l)
            # in turns (shared, global, global, shared); the mean of each
            order = ("shared", "global", "global", "shared")
            t = [time_kernel_ms(torch, runs[r], iters=50) for r in order]
            sh, gl = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            plan = forest_eval.tile_plan(G if grouped_ else 1, T, N, n, D)
            large[name][n] = {
                "shared_ms": sh, "global_ms": gl,
                "shared_over_global": sh / gl, "bound_ms": b_ms,
                "bound_by": b_by, "plan": list(plan),
                "blocks": T * (G if grouped_ else 1) * -(-n // plan.R),
                "resident": forest_eval.resident_blocks(grouped_, plan.smem,
                                                        dev),
                "taken": ("shared" if chosen(grouped_, n) is not None
                          else "global"),
                "turns_ms": t}
            print(f"{name} at {n} rows: {json.dumps(large[name][n])}")
    report["large_waves"] = large

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
    forest_ms = sum(v["device_ms"] for k, v in trace["repo_kernels"].items()
                    if k in FOREST_KERNELS)
    trace["forest_kernels_ms"] = forest_ms
    trace["forest_share_of_busy"] = (forest_ms / trace["device_busy_ms"]
                                     if trace["device_busy_ms"] else None)
    print(f"trace: {json.dumps(trace)}")
    check("tree_mean_kernel" not in trace["repo_kernels"],
          f"no tree-mean launch in the traced replay; forest kernels traced: "
          f"{sorted(k for k in trace['repo_kernels'] if k in FOREST_KERNELS)}")
    report["trace"] = trace

    # -- 5. artifacts, sharded and HTTP serving ------------------------------
    report["shard"] = shard_phase(torch, np, oracle, reqs, waves,
                                  wave_plans, args, card)

    # -- 11. live calibration, 12. the baselines ---------------------------
    report["calibration"] = calibration_phase(torch, np, oracle, waves,
                                              args, card)
    report["baselines"] = baselines_phase(np, card)

    # -- 6.-10. the LM serving path ------------------------------------------
    kernels += lm_phases(torch, np, args, dev, report)

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

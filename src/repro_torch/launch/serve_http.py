"""HTTP latency-prediction service entrypoint.

Stands ``repro_torch.serve.transport`` up over a fitted oracle and either
serves foreground traffic or replays a synthetic client load against itself:

    # self-replay (default): N concurrent clients vs the live socket
    PYTHONPATH=src python -m repro_torch.launch.serve_http \
        --requests 400 --clients 8 --wave 64

    # stay up and serve real clients
    PYTHONPATH=src python -m repro_torch.launch.serve_http --serve --port 8080

    # exercise a mid-traffic oracle refresh during the replay
    PYTHONPATH=src python -m repro_torch.launch.serve_http --refresh-mid-replay

Default is a small fast oracle (2 devices, deterministic members);
``--full`` fits the paper's 4-device grid with the DNN member (cached via
the versioned artifact store, like the advisor CLI). Everything runs on
``--device`` (default ``cuda``): the oracle's bank, and every shard
worker's, whatever ``--shard-mode``; ``--device cpu`` runs the plain
PyTorch path on the host.
"""
import argparse
import pathlib
import sys
import threading


def _fit_oracle(full: bool, cache: pathlib.Path, epochs: int, seed: int,
                device: str):
    from repro_torch import api
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig

    if full:
        cfg = ProfetConfig(dnn_epochs=epochs, seed=seed)
        return api.fit_or_load(
            cache, cfg, device=device,
            fit_fn=lambda: api.LatencyOracle.fit(workloads.generate(), cfg,
                                                 device=device))
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "ResNet18"))
    cfg = ProfetConfig(members=("linear", "forest"), n_trees=30, seed=seed)
    return api.LatencyOracle.fit(ds, cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port")
    ap.add_argument("--serve", action="store_true",
                    help="serve foreground until interrupted (no replay)")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent replay connections")
    ap.add_argument("--wave", type=int, default=64,
                    help="max requests admitted per wave")
    ap.add_argument("--cache-size", type=int, default=4096)
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="bounded admission queue (503 past it)")
    ap.add_argument("--workers", type=int, default=0,
                    help="shard the bank across this many workers "
                         "(0 = single-process wave execution)")
    ap.add_argument("--shard-mode", default="spawn",
                    choices=("spawn", "thread", "tcp"),
                    help="worker isolation for --workers: 'spawn' = "
                         "processes with shared-memory bank shards, "
                         "'thread' = in-process (tests/debug), 'tcp' = "
                         "loopback shard-worker subprocesses over the "
                         "framed socket protocol (the multi-host "
                         "topology on one machine)")
    ap.add_argument("--remote-worker", action="append", default=[],
                    metavar="HOST:PORT",
                    help="append a remote shard worker (a running "
                         "repro_torch.launch.shard_worker); repeatable")
    ap.add_argument("--worker-listen", metavar="HOST:PORT",
                    help="run as a shard WORKER on this address instead "
                         "of serving HTTP (shorthand for "
                         "repro_torch.launch.shard_worker)")
    ap.add_argument("--worker-token", default=None,
                    help="pre-shared token for the authenticated worker "
                         "handshake (defaults to $PROFET_WORKER_TOKEN); "
                         "applied to launched workers and required of "
                         "--remote-worker endpoints")
    ap.add_argument("--no-supervise", action="store_true",
                    help="disable the worker lifecycle supervisor "
                         "(leases + automatic respawn of dead shard "
                         "workers)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero if any replay request failed "
                         "(CI integration gate)")
    ap.add_argument("--refresh-mid-replay", action="store_true",
                    help="refit (new seed) and oracle_refreshed() halfway "
                         "through the replay — demonstrates epoch swap "
                         "under live traffic")
    ap.add_argument("--full", action="store_true",
                    help="paper 4-device grid + DNN member (slow fit, "
                         "cached)")
    ap.add_argument("--cache",
                    default="results/torch_serve_latency_oracle.pkl",
                    help="oracle artifact path (--full only)")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the oracle and every shard worker run "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)

    import os
    token = args.worker_token if args.worker_token is not None \
        else os.environ.get("PROFET_WORKER_TOKEN")
    if not token:
        token = None

    if args.worker_listen:
        # run as the remote half: one TCP shard worker, nothing else
        from repro_torch.launch.shard_worker import main as worker_main
        host, _, port = args.worker_listen.rpartition(":")
        cmd = ["--host", host or "127.0.0.1", "--port", port,
               "--device", args.device]
        if token is not None:
            cmd += ["--token", token]
        return worker_main(cmd)

    from repro_torch.serve import (BackgroundServer, Client,
                                   LatencyService, LifecycleConfig,
                                   ShardPlane, launch_tcp_workers, replay,
                                   synthetic_requests)

    oracle = _fit_oracle(args.full, pathlib.Path(args.cache),
                         args.epochs, args.seed, args.device)
    plane = None
    pool = None
    remote = list(args.remote_worker)
    local_workers = args.workers
    if args.shard_mode == "tcp" and args.workers > 0:
        # multi-host topology on one machine: loopback subprocess workers
        pool = launch_tcp_workers(args.workers, token=token,
                                  device=args.device)
        remote = pool.addresses + remote
        local_workers = 0
    if local_workers > 0 or remote:
        try:
            plane = ShardPlane(
                workers=local_workers,
                mode=args.shard_mode if args.shard_mode != "tcp" else "spawn",
                remote=remote, worker_token=token)
        except Exception as e:
            # an unreachable remote (or any boot failure) degrades to
            # unsharded serving, mirroring the service-level contract
            print(f"shard plane unavailable ({type(e).__name__}: {e}); "
                  "serving unsharded", file=sys.stderr)
            plane = None
    supervise = False
    if plane is not None and not args.no_supervise:
        # self-healing: lease every worker, respawn the dead. Pool-backed
        # TCP workers re-launch through the pool (new ephemeral port);
        # pure --remote-worker endpoints are re-dialed at their address.
        endpoints = {}
        if pool is not None:
            endpoints = {
                i: (lambda i=i: pool.respawn(i))
                for i in range(len(pool.addresses))}
        supervise = LifecycleConfig(endpoints=endpoints or None)
    service = LatencyService(oracle, max_wave=args.wave,
                             cache_size=args.cache_size,
                             shard_plane=plane, supervise=supervise)
    bg = BackgroundServer(service, host=args.host, port=args.port,
                          max_queue=args.max_queue).start()
    shard_note = (f"  shards: {plane.n_workers} ({args.shard_mode}"
                  + (f", {len(remote)} remote" if remote else "") + ")"
                  if plane is not None else "")
    print(f"serving http://{bg.host}:{bg.port}  "
          f"epoch {service.epoch}{shard_note}  "
          f"pairs: {', '.join(f'{a}->{t}' for a, t in oracle.pairs())}")

    try:
        if args.serve:
            print("endpoints: POST /predict /grid /advise  "
                  "GET /healthz /statsz  (ctrl-c to stop)")
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                print("\ninterrupted")
            return 0

        reqs = synthetic_requests(oracle, n=args.requests, seed=args.seed)
        swapper = None
        if args.refresh_mid_replay:
            # same grid shape as the serving oracle (the stream must stay
            # answerable), new seed = a genuinely different model; --full
            # refits into a sibling artifact so the main cache survives
            fresh = _fit_oracle(args.full,
                                pathlib.Path(args.cache + ".refresh"),
                                args.epochs, args.seed + 1, args.device)

            def swap():
                epoch = service.oracle_refreshed(fresh, "refreshed")
                print(f"  [swap] oracle refreshed mid-replay -> "
                      f"epoch {epoch}")

            swapper = threading.Timer(0.05, swap)
            swapper.start()
        rep = replay(bg.host, bg.port, reqs, clients=args.clients)
        if swapper is not None:
            swapper.join()
        s = service.stats
        print(f"replay: {rep['ok']}/{rep['n']} ok  "
              f"{len(rep['errors'])} rejected  "
              f"{rep['wall_s']:.2f} s  {rep['requests_per_s']:.0f} req/s  "
              f"client p50 {rep['client_p50_ms']:.2f} ms  "
              f"p99 {rep['client_p99_ms']:.2f} ms")
        print(f"service: {s.waves} waves  {s.fused_calls} fused calls  "
              f"{s.cache_hits} cache hits  {s.errors} errors  "
              f"epoch {s.epoch} (swaps {s.epoch_swaps}, "
              f"invalidated {s.invalidated})  "
              f"warm-up {s.warmup_ms:.0f} ms")
        if plane is not None:
            ps = plane.summary()
            print(f"shards: {ps['alive']}/{ps['workers']} alive  "
                  f"{ps['slices']} slices  "
                  f"{ps['fallback_rows']} fallback rows  "
                  f"{ps['adoptions']} adoptions")
        with Client(bg.host, bg.port) as c:
            h = c.healthz()
            print(f"healthz: {h['status']}  epoch {h['epoch']}  "
                  f"pending {h['pending']}")
        epochs = {r["epoch"] for r in rep["results"] if r is not None}
        print(f"response epochs seen: {', '.join(sorted(epochs))}")
        if args.strict and rep["ok"] != rep["n"]:
            print(f"STRICT: {rep['n'] - rep['ok']} of {rep['n']} "
                  "requests did not succeed", file=sys.stderr)
            return 1
        return 0
    finally:
        bg.stop()
        if plane is not None:
            plane.close()
        if pool is not None:
            pool.close()


if __name__ == "__main__":
    sys.exit(main())

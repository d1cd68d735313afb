"""Live-calibrated latency service entrypoint, the port of
``repro.launch.serve_calibrated``.

Stands the full self-correcting stack up — oracle, wave service,
``repro_torch.calibrate.Calibrator`` control loop, HTTP transport — and
either serves foreground traffic or runs a *drift-injection replay*
against itself: synthetic clients measure their "real" latencies from the
offline dataset, one (anchor, target) pair's truth is scaled by
``--drift`` from round ``--onset`` onward, and the measured latencies
stream back through ``POST /measure``. Watch the control loop detect the
drift, refit the pair in the background, shadow-canary the candidate, and
promote it mid-traffic (timeline printed at the end):

    # drift-injection replay (default)
    PYTHONPATH=src python -m repro_torch.launch.serve_calibrated \
        --rounds 6 --drift 1.6

    # stay up and serve real clients (calibration daemon included)
    PYTHONPATH=src python -m repro_torch.launch.serve_calibrated --serve \
        --port 8080

Everything runs on ``--device`` (default ``cuda``; asking for it without
a card raises): the fitted oracle, the calibration recovered from
``--persist-dir``, and every candidate the calibrator refits.
"""
import argparse
import pathlib
import sys
import threading
import time

import numpy as np


class DriftTruth:
    """The replay clients' 'ground truth': dataset latency with relative
    measurement noise ``noise``, the drifted ``pair`` scaled by ``drift``
    while :attr:`on`. Off-grid cases (two-phase knob values) were never run
    by a client, so they report nothing. One generator from ``seed`` for
    the whole replay, as in the reference."""

    def __init__(self, dataset, pair, drift: float, noise: float,
                 seed: int):
        self.dataset = dataset
        self.pair = tuple(pair)
        self.drift = float(drift)
        self.noise = float(noise)
        self.rng = np.random.default_rng(seed)
        self.on = False

    @property
    def label(self) -> str:
        return f"{self.pair[0]}->{self.pair[1]}"

    def __call__(self, req, res):
        case = (res["workload"]["model"], res["workload"]["batch"],
                res["workload"]["pix"])
        if case not in self.dataset.measurements.get(res["target"], {}):
            return None                    # off-grid: client never ran it
        truth = self.dataset.latency(res["target"], case)
        if self.on and (res["anchor"], res["target"]) == self.pair:
            truth *= self.drift
        return truth * (1.0 + self.rng.normal(0.0, self.noise))


def replay_round(bg, calibrator, oracle, truth: DriftTruth, rnd: int, *,
                 onset: int, requests: int, clients: int, interval: float,
                 seed: int) -> dict:
    """One round of the drift-injection replay: ``requests``
    ``synthetic_requests`` from ``clients`` concurrent clients, measured
    latencies streamed back through ``/measure``, then a pause that lets
    the control loop catch up. Prints the reference's round line and
    returns the round's record (the replay report's client p50/p99 and
    req/s, and the calibrator's summary after the pause)."""
    from repro_torch.serve import replay, synthetic_requests

    truth.on = rnd >= onset
    reqs = synthetic_requests(oracle, n=requests, seed=seed + rnd)
    rep = replay(bg.host, bg.port, reqs, clients=clients, measure_fn=truth)
    time.sleep(max(0.2, 4 * interval))  # let the loop catch up
    s = calibrator.summary()
    mape = s["rolling_mape"].get(truth.label, float("nan"))
    print(f"round {rnd}: drift={'on' if truth.on else 'off'}  "
          f"{rep['ok']}/{rep['n']} ok  "
          f"{rep['measured']} measured  state={s['state']}  "
          f"{truth.label} MAPE={mape:.1f}  epoch={s['epoch']}")
    return {"round": rnd, "drift": truth.on, "ok": rep["ok"],
            "n": rep["n"], "measured": rep["measured"],
            "errors": len(rep["errors"]),
            "p50_ms": rep["client_p50_ms"], "p99_ms": rep["client_p99_ms"],
            "requests_per_s": rep["requests_per_s"], "wall_s": rep["wall_s"],
            "state": s["state"], "mape": mape, "epoch": s["epoch"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port")
    ap.add_argument("--serve", action="store_true",
                    help="serve foreground until interrupted (no replay)")
    ap.add_argument("--rounds", type=int, default=6,
                    help="replay rounds (calibration progresses between)")
    ap.add_argument("--requests", type=int, default=120,
                    help="requests per replay round")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--wave", type=int, default=32)
    ap.add_argument("--drift", type=float, default=1.6,
                    help="factor applied to the drifted pair's true "
                         "latency from the onset round on")
    ap.add_argument("--onset", type=int, default=1,
                    help="round index the drift starts at")
    ap.add_argument("--noise", type=float, default=0.01,
                    help="relative measurement noise")
    ap.add_argument("--trigger-mape", type=float, default=10.0)
    ap.add_argument("--interval", type=float, default=0.05,
                    help="calibration control-loop period (seconds)")
    ap.add_argument("--full", action="store_true",
                    help="paper 4-device grid + DNN member (slow fit, "
                         "cached)")
    ap.add_argument("--cache",
                    default="results/torch_serve_latency_oracle.pkl",
                    help="oracle artifact path (--full only)")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--persist-dir", default="results/torch_calibration",
                    help="crash-safe calibration store: promoted "
                         "candidates are persisted here and the newest "
                         "one is recovered on restart ('' disables)")
    ap.add_argument("--device", default="cuda",
                    help="where the oracle, its recovered calibration and "
                         "every refit candidate run (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.api.artifacts import CalibrationStore
    from repro_torch.calibrate import CalibrationConfig, Calibrator
    from repro_torch.launch.serve_http import _fit_oracle
    from repro_torch.serve import BackgroundServer, Client, LatencyService

    oracle = _fit_oracle(args.full, pathlib.Path(args.cache),
                         args.epochs, args.seed, args.device)
    store = CalibrationStore(args.persist_dir) if args.persist_dir else None
    # crash recovery: a previous run's promoted calibration outlives the
    # process — serve it (under its persisted epoch) instead of the
    # freshly fitted base oracle
    serving, epoch = oracle, None
    if store is not None:
        recovered = store.recover(expect_config=oracle.config,
                                  device=args.device)
        if recovered is not None:
            serving, epoch = recovered
            print(f"recovered promoted calibration epoch {epoch} from "
                  f"{args.persist_dir}")
    service = LatencyService(serving, max_wave=args.wave, epoch=epoch)
    calibrator = Calibrator(service, CalibrationConfig(
        trigger_mape=args.trigger_mape, min_obs=8, min_refit_obs=6,
        canary_min_obs=4, confirm_obs=16, cooldown_scored=16),
        store=store)
    calibrator.start(interval=args.interval)
    bg = BackgroundServer(service, host=args.host, port=args.port,
                          calibrator=calibrator).start()
    print(f"serving http://{bg.host}:{bg.port}  epoch {service.epoch}  "
          f"pairs: {', '.join(f'{a}->{t}' for a, t in oracle.pairs())}")

    try:
        if args.serve:
            print("endpoints: POST /predict /grid /advise /measure  "
                  "GET /healthz /statsz  (ctrl-c to stop)")
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                print("\ninterrupted")
            return 0

        truth = DriftTruth(oracle.dataset, oracle.pairs()[0], args.drift,
                           args.noise, args.seed)
        print(f"drift injection: {truth.label} x{args.drift} from round "
              f"{args.onset}, trigger MAPE {args.trigger_mape}")
        for rnd in range(args.rounds):
            replay_round(bg, calibrator, oracle, truth, rnd,
                         onset=args.onset, requests=args.requests,
                         clients=args.clients, interval=args.interval,
                         seed=args.seed)
        calibrator.stop()

        print("\ncalibration timeline:")
        for ev in calibrator.stats.events:
            print(f"  * {ev}")
        s = calibrator.summary()
        print(f"\nfinal: state={s['state']}  scored={s['scored']}  "
              f"drift_events={s['drift_events']}  refits={s['refits']}  "
              f"canary {s['canary_pass']}/"
              f"{s['canary_pass'] + s['canary_fail']}"
              f" passed  promotions={s['promotions']}  "
              f"rollbacks={s['rollbacks']}  confirms={s['confirms']}")
        with Client(bg.host, bg.port) as c:
            st = c.statsz()
            print(f"statsz: epoch {st['stats']['epoch']}  "
                  f"swaps {st['stats']['epoch_swaps']}  "
                  f"calibration state {st['calibration']['state']}")
        return 0
    finally:
        calibrator.stop()
        bg.stop()


if __name__ == "__main__":
    sys.exit(main())

"""Async HTTP transport over ``repro_torch.serve.LatencyService``.

The layer that turns the in-process wave-microbatching service into
something a client can actually hit: a stdlib-``asyncio`` HTTP/1.1 front
end speaking a minimal JSON protocol. Concurrent connections admit their
requests into the service's queue; a single pump coroutine drains the queue
in fused waves on a worker thread and resolves one future per request —
so N clients arriving together cost one fused ensemble call per device
pair, not N round-trips through the model.

Endpoints (all bodies and responses are JSON):

  - ``POST /predict`` — one ``PredictRequest``; answers
    ``{"ok": true, "result": {...}}`` with the prediction, resolved mode,
    price, and the oracle *epoch* that answered it.
  - ``POST /grid``    — a ``GridRequest`` sweep; every feasible cell rides
    the same wave queue (shared rows fuse in the executor) and reassembles
    into the dense NaN-padded grid.
  - ``POST /advise``  — the advisor sweep (anchor, workload, optional
    measured_ms/targets); one row per reachable target. When a calibrator
    is attached, a supplied ``measured_ms`` is also ingested as a live
    observation (free ground truth off the advise path).
  - ``POST /measure`` — the measurement firehose: a *columnar* batch
    (array per field: anchor/target/model/batch/pix/latency_ms, optional
    predicted_ms) of client-measured latencies for live calibration;
    answers ``{"ok": true, "accepted": n, "dropped": d}``. 422 when the
    server runs without a calibrator.
  - ``GET /healthz``  — liveness + current epoch + queue depth.
  - ``GET /statsz``   — ``ServiceStats.summary()`` (waves, fused calls,
    cache hits lifetime/per-epoch, swaps, overloads, p50/p99, ...) plus a
    ``calibration`` block (state, drift, canary verdicts, promotions)
    when a calibrator is attached.

Back-pressure: admission is bounded by ``max_queue`` *unresolved* requests
(queued + mid-wave). Past it, requests are rejected immediately with a
typed ``OverloadedError`` payload and HTTP 503 — the queue never grows
without bound. Malformed payloads get a typed ``MalformedRequestError``
response on a still-open connection; typed ``ApiError`` subclasses map to
4xx with their class name on the wire.

Oracle refresh: calling ``service.oracle_refreshed(new_oracle, fp)`` from
any thread swaps the model mid-traffic — in-flight waves drain on the old
oracle, later admissions are planned/executed/cached under the new epoch,
and every response carries the epoch that answered it, so zero stale-epoch
responses are observable (``tests/test_transport.py`` asserts it).

``Client`` is the matching blocking keep-alive client (stdlib ``socket``);
``replay`` is the multi-threaded load generator ``launch/serve_http.py``
and ``benchmarks/bench_transport.py`` drive.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import oracle as oracle_mod
from repro_torch.api.types import (ApiError, ExecutionError, GridRequest,
                             KNOB_BATCH, KNOB_PIXEL, MODE_AUTO,
                             MalformedRequestError, OverloadedError,
                             PredictRequest, PredictResult,
                             UnsupportedRequestError, Workload)
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import frames
from repro_torch.serve.latency_service import LatencyService
from repro_torch.serve.resilience import LEGACY_RETRY, RetryPolicy

PROTOCOL = "profet/1"

# HTTP status per error class; unlisted ApiErrors fall back to 400.
# ShardExecutionError maps to 500 like any execution failure — but it is
# scoped to the requests whose rows rode the failed shard slice, never
# the whole wave.
_STATUS = {"OverloadedError": 503, "MalformedRequestError": 400,
           "UnknownDeviceError": 404, "UnsupportedRequestError": 422,
           "InvalidWorkloadError": 400, "ExecutionError": 500,
           "ShardExecutionError": 500,
           "DeadlineExceededError": 504, "CircuitOpenError": 503}

#: Content-Type of the binary columnar /measure body (see
#: ``measure_binary_from_rows`` for the layout).
COLUMNAR_CONTENT_TYPE = "application/x-profet-columnar"


# ----------------------------------------------------------------------
# wire <-> typed conversions
# ----------------------------------------------------------------------

def result_to_dict(res: PredictResult) -> Dict[str, Any]:
    d = dataclasses.asdict(res)
    d["workload"] = dataclasses.asdict(res.workload)
    return d


def predict_request_from_dict(d: Any) -> PredictRequest:
    if not isinstance(d, dict):
        raise MalformedRequestError(
            f"predict payload must be a JSON object, got {type(d).__name__}")
    try:
        w = d["workload"]
        workload = Workload(model=str(w["model"]), batch=int(w["batch"]),
                            pix=int(w["pix"]))
        profile = d.get("profile")
        if profile is not None:
            profile = {str(k): float(v) for k, v in profile.items()}
        deadline = d.get("deadline_ms")
        if deadline is not None:
            deadline = float(deadline)
        return PredictRequest(anchor=str(d["anchor"]),
                              target=str(d["target"]), workload=workload,
                              profile=profile,
                              mode=str(d.get("mode", MODE_AUTO)),
                              knob=str(d.get("knob", KNOB_BATCH)),
                              deadline_ms=deadline)
    except ApiError:
        raise                      # typed already (e.g. InvalidWorkloadError)
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise MalformedRequestError(f"bad predict payload: {e!r}") from e


def grid_request_from_dict(d: Any) -> GridRequest:
    if not isinstance(d, dict):
        raise MalformedRequestError(
            f"grid payload must be a JSON object, got {type(d).__name__}")
    try:
        return GridRequest(anchor=str(d["anchor"]), model=str(d["model"]),
                           targets=tuple(str(t) for t in d["targets"]),
                           batches=tuple(int(b) for b in d["batches"]),
                           pixels=tuple(int(p) for p in d["pixels"]))
    except (KeyError, TypeError, ValueError) as e:
        raise MalformedRequestError(f"bad grid payload: {e!r}") from e


def _error_payload(e: Exception) -> Tuple[int, Dict[str, Any]]:
    name = type(e).__name__
    return (_STATUS.get(name, 400 if isinstance(e, ApiError) else 500),
            {"ok": False, "error": {"type": name, "message": str(e)}})


# ----------------------------------------------------------------------
# the asyncio server
# ----------------------------------------------------------------------

class TransportServer:
    """HTTP/1.1 front end over one :class:`LatencyService`.

    Run it inside an event loop (``await server.start()``) or, from
    synchronous code, via :class:`BackgroundServer`. ``max_queue`` bounds
    unresolved admissions; ``pause()``/``resume()`` gate the wave pump
    (drain-for-maintenance, and a deterministic seam for overload tests).
    """

    def __init__(self, service: LatencyService, *, host: str = "127.0.0.1",
                 port: int = 0, max_queue: int = 1024,
                 batch_window_s: float = 0.005, calibrator=None,
                 faults=None):
        self.service = service
        # optional repro_torch.calibrate.Calibrator: receives /measure batches
        # and advise-path ground truth; exports its stats under /statsz
        self.calibrator = calibrator
        self.host = host
        self.port = port
        self.max_queue = int(max_queue)
        self.batch_window_s = float(batch_window_s)
        self._futs: Dict[int, asyncio.Future] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._paused = False
        # deterministic fault injection (chaos tests); None in production
        self._faults = faults
        # sticky until the restarted pump completes a clean drain hop —
        # /healthz answers "degraded" meanwhile instead of lying "ok"
        self._pump_degraded = False

    # ------------------------------------------------------------------
    async def start(self) -> "TransportServer":
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.create_task(self._pump_supervisor())
        return self

    async def stop(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for fut in self._futs.values():
            if not fut.done():
                fut.set_exception(ConnectionError("server stopped"))
        self._futs.clear()

    def pause(self) -> None:
        """Stop admitting waves (queued requests wait; admissions still
        accepted until ``max_queue``)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False
        self._loop.call_soon_threadsafe(self._wake.set)

    # ------------------------------------------------------------------
    # admission + wave pump
    # ------------------------------------------------------------------
    def _admit(self, reqs: Sequence[PredictRequest]) -> List[asyncio.Future]:
        """Bounded admission: all-or-nothing enqueue of a request group."""
        if len(self._futs) + len(reqs) > self.max_queue:
            self.service.stats.overloads += 1
            raise OverloadedError(
                f"admission queue full ({len(self._futs)} unresolved, "
                f"max {self.max_queue}); retry later")
        futs = []
        for r in reqs:
            sr = self.service.submit(r)
            fut = self._loop.create_future()
            self._futs[sr.uid] = fut
            futs.append(fut)
        self._wake.set()
        return futs

    async def _pump_supervisor(self) -> None:
        """Keep the wave pump alive: a crashed pump task (a bug below
        run_once's own isolation, or an injected ``transport.pump`` fault)
        is accounted (``stats.pump_crashes``/``pump_restarts``), its
        finished requests are resolved, requests the crash *lost* (neither
        finished nor still queued) are failed as typed 500s, and the pump
        restarts with exponential backoff. ``/healthz`` answers
        ``degraded`` from the crash until a restarted pump completes a
        clean drain hop."""
        backoff = 0.01
        while True:
            try:
                await self._pump()
                return                      # pump exited cleanly (never)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                stats = self.service.stats
                stats.pump_crashes += 1
                self._pump_degraded = True
                self._resolve_finished()
                queued = self.service.queued_uids()
                for uid in [u for u in self._futs if u not in queued]:
                    fut = self._futs.pop(uid)
                    if not fut.done():
                        fut.set_exception(ExecutionError(
                            f"wave pump crashed mid-flight: {e!r}"))
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2.0, 1.0)
                stats.pump_restarts += 1
                self._wake.set()            # reprocess whatever is queued

    def _resolve_finished(self) -> None:
        for sr in self.service.take_finished():
            fut = self._futs.pop(sr.uid, None)
            if fut is not None and not fut.done():
                fut.set_result(sr)

    async def _pump(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            while self.service.pending() and not self._paused:
                faults_mod.fire(self._faults, faults_mod.SITE_PUMP)
                # admission window (the standard microbatching trade): give
                # concurrently-arriving requests a moment to join the wave,
                # then run the blocking fused drain on a worker thread —
                # the loop keeps accepting + admitting meanwhile, so
                # requests landing mid-wave batch into the next one
                if self.batch_window_s > 0:
                    await asyncio.sleep(self.batch_window_s)
                # ONE wave per hop, so a wave's responses flush the moment
                # it completes — a full-drain call would withhold early
                # waves' results while later admissions keep it looping.
                # The service fails broken waves per-request, so run_once()
                # raising is already a bug — but a dead pump would hang
                # every queued client behind a green /healthz, so resolve
                # what finished, fail what the wave lost (neither finished
                # nor still queued), and keep pumping regardless.
                try:
                    await self._loop.run_in_executor(None,
                                                     self.service.run_once)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self._resolve_finished()
                    queued = self.service.queued_uids()
                    for uid in [u for u in self._futs if u not in queued]:
                        fut = self._futs.pop(uid)
                        if not fut.done():
                            fut.set_exception(e)
                    continue
                self._resolve_finished()
                # a clean drain hop after a crash: the pump has proven
                # itself again, stop reporting degraded
                self._pump_degraded = False

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Pipelined connection handler: the read loop turns every request
        into a dispatch task the moment its bytes arrive (no waiting for
        the previous response), and :meth:`_write_loop` writes responses
        strictly in request order. A client that fires K ``/measure``
        batches back-to-back pays ~one round-trip for all K instead of K
        — the ROADMAP firehose gap — while slow endpoints ahead in the
        pipeline never reorder responses behind them."""
        q: "asyncio.Queue" = asyncio.Queue()
        wtask = asyncio.create_task(self._write_loop(q, writer))
        try:
            while True:
                parsed = await self._read_request(reader)
                if parsed is None:
                    break
                method, path, headers, body, framing_ok = parsed
                if not framing_ok:
                    await q.put((None, (400, {
                        "ok": False,
                        "error": {"type": "MalformedRequestError",
                                  "message": "unparseable HTTP framing"}}),
                        False))
                    break
                keep = headers.get("connection", "").lower() != "close"
                task = asyncio.create_task(
                    self._dispatch(method, path, headers, body))
                await q.put((task, None, keep))
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass
        finally:
            await q.put(None)
            try:
                await wtask
            except Exception:
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _write_loop(self, q: "asyncio.Queue",
                          writer: asyncio.StreamWriter) -> None:
        """Drain the response queue FIFO. After the connection is torn
        down (Connection: close, an injected drop, or a socket error) the
        loop keeps *settling* remaining dispatch tasks — their requests
        were admitted and will execute — without writing."""
        closing = False
        while True:
            item = await q.get()
            if item is None:
                return
            task, ready, keep = item
            if task is not None:
                try:
                    status, payload = await task
                except Exception as e:
                    status, payload = _error_payload(e)
            else:
                status, payload = ready
            if closing:
                continue
            data = json.dumps(payload).encode()
            head = (b"HTTP/1.1 %d %s\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: %d\r\n"
                    b"X-Profet-Protocol: %s\r\n"
                    b"Connection: %s\r\n\r\n"
                    % (status, _reason(status).encode(), len(data),
                       PROTOCOL.encode(),
                       b"keep-alive" if keep else b"close"))
            try:
                if faults_mod.should_drop(self._faults,
                                          faults_mod.SITE_RESPONSE):
                    # injected socket reset mid-response: the request WAS
                    # executed, but the client sees a truncated response
                    # and a dead connection — the retry-safety scenario.
                    # Closing here also EOFs the read loop.
                    writer.write(head + data[:max(1, len(data) // 2)])
                    await writer.drain()
                    writer.close()
                    closing = True
                    continue
                writer.write(head)
                writer.write(data)
                await writer.drain()
            except (ConnectionError, OSError):
                closing = True
                continue
            if not keep:
                writer.close()
                closing = True

    async def _read_request(self, reader: asyncio.StreamReader):
        """One HTTP request off the stream. Returns None on clean EOF,
        or (method, path, headers, body, framing_ok). ``framing_ok=False``
        flags an unparseable request line/headers — answered with a typed
        400, then the connection closes (resync is impossible)."""
        headers: Dict[str, str] = {}
        try:
            line = await reader.readline()
            if not line:
                return None
            parts = line.decode("latin-1").strip().split()
            if len(parts) != 3:
                return "?", "?", headers, b"", False
            method, path, _ = parts
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                if b":" not in h:
                    return method, path, headers, b"", False
                k, v = h.decode("latin-1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
            n = int(headers.get("content-length", "0"))
            body = await reader.readexactly(n) if n else b""
        except ValueError:
            # over-limit request/header line (StreamReader raises bare
            # ValueError past its 64 KiB limit) or a bad content-length —
            # answer with the typed 400, don't drop the connection silently
            return "?", "?", headers, b"", False
        return method, path, headers, body, True

    def _health_status(self) -> Tuple[str, List[str]]:
        """Honest liveness: "degraded" (with reasons) while the pump is
        recovering from a crash, the service runs a fallback path, or any
        (anchor, target) pair is quarantined — else "ok"."""
        reasons = []
        if self._pump_degraded:
            reasons.append("pump restarted after crash; awaiting a clean "
                           "drain hop")
        stats = self.service.stats
        if stats.degraded:
            reasons.append(stats.degraded_reason or "service degraded")
        open_pairs = self.service.breaker.open_keys()
        if open_pairs:
            reasons.append("circuit open: " + ", ".join(
                f"{a}->{t}" for a, t in sorted(open_pairs)))
        plane = getattr(self.service, "shard_plane", None)
        if plane is not None:
            dead = plane.n_workers - plane.alive_workers()
            if dead:
                reasons.append(
                    f"{dead}/{plane.n_workers} shard workers dead; their "
                    "slices serve through the single-worker fallback")
            sup = getattr(plane, "supervisor", None)
            if sup is not None:
                states = sup.summary()["states"]
                unhealthy = {s: n for s, n in states.items()
                             if s not in ("live", "adopted") and n}
                if unhealthy:
                    reasons.append(
                        "worker lifecycle: " + ", ".join(
                            f"{n} {s}" for s, n in sorted(
                                unhealthy.items())))
        return ("degraded" if reasons else "ok"), reasons

    async def _dispatch(self, method: str, path: str,
                        headers: Dict[str, str],
                        body: bytes) -> Tuple[int, Dict[str, Any]]:
        try:
            if path == "/healthz":
                if method != "GET":
                    return 405, _method_not_allowed(method)
                status, reasons = self._health_status()
                out = {"ok": True, "status": status,
                       "reasons": reasons,
                       "protocol": PROTOCOL,
                       "epoch": self.service.epoch,
                       "pairs": len(self.service.oracle.pairs()),
                       "pending": len(self._futs),
                       "paused": self._paused,
                       "pump_crashes":
                           self.service.stats.pump_crashes}
                plane = getattr(self.service, "shard_plane", None)
                sup = getattr(plane, "supervisor", None)
                if sup is not None:
                    # per-worker lifecycle: state + lease age + respawns
                    out["workers"] = [
                        {"state": w["state"],
                         "lease_age_s": w["lease_age_s"],
                         "respawns": w["respawns"]}
                        for w in sup.summary()["workers"]]
                return 200, out
            if path == "/statsz":
                if method != "GET":
                    return 405, _method_not_allowed(method)
                out = {"ok": True,
                       "stats": self.service.stats.summary(),
                       "pending": len(self._futs),
                       "max_queue": self.max_queue}
                if self.calibrator is not None:
                    out["calibration"] = self.calibrator.summary()
                plane = getattr(self.service, "shard_plane", None)
                if plane is not None:
                    out["shard"] = plane.summary()
                return 200, out
            deadline = _deadline_from_headers(headers)
            if path == "/predict":
                if method != "POST":
                    return 405, _method_not_allowed(method)
                return await self._predict(_decode_json(body), deadline)
            if path == "/grid":
                if method != "POST":
                    return 405, _method_not_allowed(method)
                return await self._grid(_decode_json(body), deadline)
            if path == "/advise":
                if method != "POST":
                    return 405, _method_not_allowed(method)
                return await self._advise(_decode_json(body), deadline)
            if path == "/measure":
                if method != "POST":
                    return 405, _method_not_allowed(method)
                return self._measure(headers, body)
            return 404, {"ok": False,
                         "error": {"type": "NotFound",
                                   "message": f"no route {path!r}"}}
        except Exception as e:  # every error leaves as a typed payload
            return _error_payload(e)

    # ------------------------------------------------------------------
    # endpoints
    # ------------------------------------------------------------------
    async def _predict(self, payload: Any,
                       deadline_ms: Optional[float] = None
                       ) -> Tuple[int, Dict[str, Any]]:
        req = _with_deadline(predict_request_from_dict(payload),
                             deadline_ms)
        [fut] = self._admit([req])
        sr = await fut
        if sr.error is not None:
            status, out = _error_payload(sr.error)
            return status, out
        return 200, {"ok": True, "result": result_to_dict(sr.result),
                     "service_ms": sr.latency_ms}

    def _check_sweep_size(self, what: str, n: int) -> None:
        """A sweep larger than the whole admission queue can never be
        admitted — that is a permanent request-shape problem (422), not a
        transient overload (503 'retry later')."""
        if n > self.max_queue:
            raise UnsupportedRequestError(
                f"{what} expands to {n} cell requests, more than the "
                f"admission queue holds ({self.max_queue}); split the "
                "sweep")

    async def _grid(self, payload: Any,
                    deadline_ms: Optional[float] = None
                    ) -> Tuple[int, Dict[str, Any]]:
        greq = grid_request_from_dict(payload)
        oracle = self.service.oracle
        reqs, scatter = oracle.stage_grid(greq)   # validates anchor/pairs
        self._check_sweep_size("grid", len(reqs))
        reqs = [_with_deadline(r, deadline_ms) for r in reqs]
        srs = [await f for f in self._admit(reqs)]
        for sr in srs:
            if sr.error is not None:
                return _error_payload(sr.error)
        lat = np.array([sr.result.latency_ms for sr in srs])
        grid = oracle_mod.assemble_grid(greq, scatter, lat)
        return 200, {"ok": True, "grid": grid.to_dict(),
                     "epochs": sorted({sr.result.epoch for sr in srs})}

    async def _advise(self, payload: Any,
                      deadline_ms: Optional[float] = None
                      ) -> Tuple[int, Dict[str, Any]]:
        if not isinstance(payload, dict):
            raise MalformedRequestError(
                f"advise payload must be a JSON object, "
                f"got {type(payload).__name__}")
        try:
            anchor = str(payload["anchor"])
            w = payload["workload"]
            workload = Workload(model=str(w["model"]),
                                batch=int(w["batch"]), pix=int(w["pix"]))
            profile = payload.get("profile")
            if profile is not None:
                profile = {str(k): float(v) for k, v in profile.items()}
            measured = payload.get("measured_ms")
            measured = None if measured is None else float(measured)
            targets = payload.get("targets")
            targets = None if targets is None else [str(t) for t in targets]
        except ApiError:
            raise
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise MalformedRequestError(f"bad advise payload: {e!r}") from e
        if measured is not None and self.calibrator is not None:
            # a client that measured its own anchor latency just handed us
            # live ground truth for the (anchor, anchor) measured-mode pair
            # — feed the calibrator for free (never fail the sweep over it)
            try:
                self.calibrator.ingest(anchor, anchor, workload, measured)
            except Exception:
                pass
        oracle = self.service.oracle
        reqs, scatter = oracle.stage_advise(anchor, workload, profile,
                                            measured, targets)
        self._check_sweep_size("advise", len(reqs))
        reqs = [_with_deadline(r, deadline_ms) for r in reqs]
        srs = [await f for f in self._admit(reqs)]
        for sr in srs:
            if sr.error is not None:
                return _error_payload(sr.error)
        rows = oracle_mod.assemble_advise(scatter,
                                          [sr.result for sr in srs],
                                          epoch=self.service.epoch)
        return 200, {"ok": True,
                     "rows": [result_to_dict(r) for r in rows]}

    def _measure(self, headers: Dict[str, str],
                 body: bytes) -> Tuple[int, Dict[str, Any]]:
        if self.calibrator is None:
            raise UnsupportedRequestError(
                "this server runs without a calibrator; /measure is "
                "unavailable")
        ctype = headers.get("content-type", "").split(";")[0].strip().lower()
        if ctype == COLUMNAR_CONTENT_TYPE:
            # hot ingest path: length-prefixed binary arrays, decoded with
            # np.frombuffer — no JSON parse, no per-row Python objects
            # until the calibrator's row dicts
            rows = measure_rows_from_binary(body)
        else:
            rows = measure_rows_from_columnar(_decode_json(body))
        accepted, dropped = self.calibrator.ingest_rows(rows)
        return 200, {"ok": True, "accepted": accepted, "dropped": dropped}


# columnar /measure wire format: one array per field, row i across all
# arrays is one observation. Dense, schema-checked once per batch, and
# cheap to build from the flat lists a load generator already keeps.
_MEASURE_FIELDS = ("anchor", "target", "model", "batch", "pix",
                   "latency_ms")


def measure_rows_from_columnar(payload: Any) -> List[Dict[str, Any]]:
    """Decode a columnar ``/measure`` batch into per-observation rows.
    ``predicted_ms`` and ``epoch`` are optional (arrays with ``null``
    holes allowed); ragged or missing columns raise
    :class:`MalformedRequestError`."""
    if not isinstance(payload, dict):
        raise MalformedRequestError(
            f"measure payload must be a JSON object of arrays, "
            f"got {type(payload).__name__}")
    cols: Dict[str, list] = {}
    n = None
    for field in _MEASURE_FIELDS:
        col = payload.get(field)
        if not isinstance(col, (list, tuple)):
            raise MalformedRequestError(
                f"measure field {field!r} must be an array "
                f"(columnar batch), got {type(col).__name__}")
        if n is None:
            n = len(col)
        elif len(col) != n:
            raise MalformedRequestError(
                f"ragged measure batch: field {field!r} has {len(col)} "
                f"rows, expected {n}")
        cols[field] = list(col)
    optional = {}
    for field in ("predicted_ms", "epoch"):
        col = payload.get(field)
        if col is None:
            continue
        if not isinstance(col, (list, tuple)) or len(col) != n:
            raise MalformedRequestError(
                f"measure field {field!r} must be an array matching the "
                "batch length (null holes allowed)")
        optional[field] = list(col)
    rows = []
    for i in range(n or 0):
        row = {field: cols[field][i] for field in _MEASURE_FIELDS}
        for field, col in optional.items():
            if col[i] is not None:
                row[field] = col[i]
        rows.append(row)
    return rows


def measure_columnar_from_rows(rows: Sequence[Dict[str, Any]]
                               ) -> Dict[str, list]:
    """The inverse: per-observation rows -> the columnar wire body."""
    body: Dict[str, list] = {f: [r[f] for r in rows]
                             for f in _MEASURE_FIELDS}
    body["predicted_ms"] = [r.get("predicted_ms") for r in rows]
    body["epoch"] = [r.get("epoch") for r in rows]
    return body


# binary columnar /measure wire format (Content-Type:
# application/x-profet-columnar) — the zero-JSON hot ingest path:
#
#   magic  b"PFC1"
#   u32    n                      (row count, little-endian)
#   u8     flags                  (bit0: predicted_ms, bit1: epoch)
#   str    anchor, target, model  (each: u32 lens[n] + concat utf-8;
#                                  len 0xFFFFFFFF encodes null)
#   i64    batch[n], pix[n]
#   f64    latency_ms[n]
#   f64    predicted_ms[n]        (if flags bit0; NaN encodes null)
#   str    epoch                  (if flags bit1; nullable)
#
# Every array decodes with one np.frombuffer slice; the only per-row
# Python work is assembling the calibrator's row dicts.

# The column primitives (bounds-checked cursor, nullable string packing)
# live in repro_torch.serve.frames — the shard worker wire protocol reuses the
# exact same layout for its tensor payloads.
_PFC_MAGIC = frames.PFC_MAGIC
_PFC_NULL_LEN = frames.PFC_NULL_LEN
_pfc_pack_str = frames.pack_str_column


class _PfcReader(frames.Reader):
    """Cursor over a binary columnar body; every read is bounds-checked
    so a truncated or lying body raises a typed 400, never an IndexError
    deep inside numpy."""

    error = MalformedRequestError


def measure_binary_from_rows(rows: Sequence[Dict[str, Any]]) -> bytes:
    """Encode per-observation rows as the binary columnar body."""
    n = len(rows)
    has_pred = any(r.get("predicted_ms") is not None for r in rows)
    has_epoch = any(r.get("epoch") is not None for r in rows)
    flags = (1 if has_pred else 0) | (2 if has_epoch else 0)
    parts = [_PFC_MAGIC,
             np.uint32(n).tobytes(), np.uint8(flags).tobytes()]
    try:
        for f in ("anchor", "target", "model"):
            parts.append(_pfc_pack_str([r[f] for r in rows]))
        for f in ("batch", "pix"):
            parts.append(np.array([int(r[f]) for r in rows],
                                  "<i8").tobytes())
        parts.append(np.array([float(r["latency_ms"]) for r in rows],
                              "<f8").tobytes())
    except (KeyError, TypeError, ValueError) as e:
        raise MalformedRequestError(f"bad measure row: {e!r}") from e
    if has_pred:
        parts.append(np.array(
            [np.nan if r.get("predicted_ms") is None
             else float(r["predicted_ms"]) for r in rows], "<f8").tobytes())
    if has_epoch:
        parts.append(_pfc_pack_str([r.get("epoch") for r in rows]))
    return b"".join(parts)


def measure_rows_from_binary(body: bytes) -> List[Dict[str, Any]]:
    """Decode a binary columnar body into the same per-observation rows
    :func:`measure_rows_from_columnar` yields — the calibrator cannot
    tell which codec a batch arrived through."""
    if body[:4] != _PFC_MAGIC:
        raise MalformedRequestError(
            f"bad columnar magic {body[:4]!r} (expected {_PFC_MAGIC!r})")
    r = _PfcReader(body)
    r.off = 4
    n = int(r.array("<u4", 1)[0])
    flags = int(r.array("<u1", 1)[0])
    cols: Dict[str, Any] = {}
    for f in ("anchor", "target", "model"):
        col = r.strings(n)
        if any(s is None for s in col):
            raise MalformedRequestError(
                f"measure field {f!r} cannot carry nulls")
        cols[f] = col
    cols["batch"] = r.array("<i8", n)
    cols["pix"] = r.array("<i8", n)
    cols["latency_ms"] = r.array("<f8", n)
    pred = r.array("<f8", n) if flags & 1 else None
    epoch = r.strings(n) if flags & 2 else None
    if r.off != len(body):
        raise MalformedRequestError(
            f"trailing bytes in columnar body ({len(body) - r.off})")
    rows = []
    for i in range(n):
        row = {"anchor": cols["anchor"][i], "target": cols["target"][i],
               "model": cols["model"][i], "batch": int(cols["batch"][i]),
               "pix": int(cols["pix"][i]),
               "latency_ms": float(cols["latency_ms"][i])}
        if pred is not None and not np.isnan(pred[i]):
            row["predicted_ms"] = float(pred[i])
        if epoch is not None and epoch[i] is not None:
            row["epoch"] = epoch[i]
        rows.append(row)
    return rows


def _deadline_from_headers(headers: Dict[str, str]) -> Optional[float]:
    """Parse the ``X-Deadline-Ms`` header (budget from receipt, in ms)."""
    raw = headers.get("x-deadline-ms")
    if raw is None:
        return None
    try:
        v = float(raw)
    except ValueError:
        raise MalformedRequestError(
            f"X-Deadline-Ms must be a number of milliseconds, "
            f"got {raw!r}") from None
    if v <= 0:
        raise MalformedRequestError(
            f"X-Deadline-Ms must be positive, got {v}")
    return v


def _with_deadline(req: PredictRequest,
                   deadline_ms: Optional[float]) -> PredictRequest:
    """Apply a transport-level deadline; a deadline already in the body
    wins (it is more specific than the header)."""
    if deadline_ms is None or req.deadline_ms is not None:
        return req
    return dataclasses.replace(req, deadline_ms=deadline_ms)


def _decode_json(body: bytes) -> Any:
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MalformedRequestError(f"body is not valid JSON: {e}") from e


def _method_not_allowed(method: str) -> Dict[str, Any]:
    return {"ok": False, "error": {"type": "MethodNotAllowed",
                                   "message": f"method {method!r}"}}


def _reason(status: int) -> str:
    return {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 422: "Unprocessable Entity",
            500: "Internal Server Error",
            503: "Service Unavailable",
            504: "Gateway Timeout"}.get(status, "Unknown")


# ----------------------------------------------------------------------
# background runner (tests, benchmarks, CLI)
# ----------------------------------------------------------------------

class BackgroundServer:
    """A :class:`TransportServer` on its own event-loop thread, so
    synchronous code (pytest, benchmarks, the CLI's self-replay mode) can
    stand a live socket up and tear it down."""

    def __init__(self, service: LatencyService, **kwargs):
        self.server = TransportServer(service, **kwargs)
        self._thread = threading.Thread(target=self._run,
                                        name="profet-transport", daemon=True)
        self._started = threading.Event()
        self._stop_event: Optional[asyncio.Event] = None

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        await self.server.start()
        self._stop_event = asyncio.Event()
        self._started.set()
        await self._stop_event.wait()
        await self.server.stop()

    def start(self, timeout: float = 10.0) -> "BackgroundServer":
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("transport server failed to start")
        return self

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def host(self) -> str:
        return self.server.host

    def stop(self, timeout: float = 10.0) -> None:
        if self._stop_event is not None:
            self.server._loop.call_soon_threadsafe(self._stop_event.set)
        self._thread.join(timeout)


# ----------------------------------------------------------------------
# blocking client + load generator
# ----------------------------------------------------------------------

class TransportError(RuntimeError):
    """A non-2xx transport response, carrying the typed error payload."""

    def __init__(self, status: int, error: Dict[str, Any]):
        super().__init__(f"[{status}] {error.get('type')}: "
                         f"{error.get('message')}")
        self.status = status
        self.error = error or {}

    @property
    def error_type(self) -> str:
        return str(self.error.get("type", ""))


class Client:
    """Minimal blocking keep-alive HTTP client for the transport (stdlib
    ``socket`` only). One instance == one connection; use one per thread.

    ``retry`` governs recovery from connection failures and (opt-in)
    retryable statuses like 503, with exponential backoff + seeded
    jitter. Retry safety: a request is blind-retried after a connection
    failure only when (a) the request never made it fully onto the wire
    (the server cannot have executed it), or (b) the caller marked it
    idempotent (every GET, and POSTs whose re-execution is harmless —
    /predict, /grid, /advise). A non-idempotent body (``/measure``: each
    delivery ingests rows into the calibration buffers) whose *response*
    was lost after a complete send is NEVER re-sent — the failure
    surfaces to the caller instead of silently double-ingesting."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retry = retry if retry is not None else LEGACY_RETRY
        self._rng = self.retry.rng()
        self._sock: Optional[socket.socket] = None
        self._rbuf = b""      # bytes past the last parsed response
        # connection-level pipelining state: tags of requests whose
        # responses have not been read yet, and the (tag, status, payload)
        # triples collected when a later call drains them
        self._pending: List[Any] = []
        self._collected: List[Tuple[Any, int, Dict[str, Any]]] = []
        # /measure codec negotiation: None = not yet negotiated, True =
        # server accepted the binary columnar body, False = JSON only
        self._measure_binary: Optional[bool] = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=self.timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
        self._rbuf = b""
        self._pending.clear()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low level ------------------------------------------------------
    def _encode_request(self, method: str, path: str, payload: Any,
                        headers: Optional[Dict[str, str]],
                        raw_body: Optional[bytes],
                        content_type: str) -> bytes:
        if raw_body is not None:
            body = raw_body
        else:
            body = b"" if payload is None else json.dumps(payload).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        return (f"{method} {path} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extra}"
                f"Connection: keep-alive\r\n\r\n").encode() + body

    def send_pipelined(self, method: str, path: str, payload: Any = None,
                       *, headers: Optional[Dict[str, str]] = None,
                       raw_body: Optional[bytes] = None,
                       content_type: str = "application/json",
                       tag: Any = None) -> None:
        """Fire a request WITHOUT reading its response — connection-level
        pipelining. The response is read later, in send order, by
        :meth:`drain` (or implicitly by the next synchronous
        :meth:`request`) and parked in :meth:`take_collected` under
        ``tag``. Pipelined sends never blind-retry: by the time a failure
        is observed the bytes are long on the wire."""
        data = self._encode_request(method, path, payload, headers,
                                    raw_body, content_type)
        sock = self._connect()
        try:
            sock.sendall(data)
        except (ConnectionError, socket.timeout, OSError):
            self.close()
            raise
        self._pending.append(tag)

    def drain(self) -> List[Tuple[Any, int, Dict[str, Any]]]:
        """Read every pipelined response still in flight (send order),
        append them to the collected list, and return the newly drained
        ``(tag, status, payload)`` triples."""
        out: List[Tuple[Any, int, Dict[str, Any]]] = []
        while self._pending:
            tag = self._pending[0]
            try:
                status, payload = self._read_response(self._connect())
            except (ConnectionError, socket.timeout, OSError):
                self.close()
                raise
            self._pending.pop(0)
            out.append((tag, status, payload))
        self._collected.extend(out)
        return out

    def take_collected(self) -> List[Tuple[Any, int, Dict[str, Any]]]:
        """Return and clear every pipelined response drained so far."""
        out, self._collected = self._collected, []
        return out

    def request(self, method: str, path: str, payload: Any = None,
                idempotent: bool = True,
                headers: Optional[Dict[str, str]] = None,
                raw_body: Optional[bytes] = None,
                content_type: str = "application/json"
                ) -> Tuple[int, Dict[str, Any]]:
        if self._pending:
            # responses arrive in send order: anything pipelined ahead of
            # this synchronous call must be read (and parked) first
            self.drain()
        data = self._encode_request(method, path, payload, headers,
                                    raw_body, content_type)
        policy = self.retry
        attempt = 1
        while True:
            sent = False
            try:
                sock = self._connect()
                sock.sendall(data)
                sent = True
                status, out = self._read_response(sock)
            except (ConnectionError, socket.timeout, OSError):
                self.close()
                # once the full request is on the wire, the server may
                # have executed it even though its response was lost —
                # re-sending a non-idempotent body would double-execute
                # (e.g. /measure double-ingesting observations)
                if (sent and not idempotent) \
                        or attempt >= policy.max_attempts:
                    raise
                time.sleep(policy.backoff_s(attempt, self._rng))
                attempt += 1
                continue
            if status in policy.retry_statuses \
                    and attempt < policy.max_attempts:
                time.sleep(policy.backoff_s(attempt, self._rng))
                attempt += 1
                continue
            return status, out

    def _read_response(self, sock: socket.socket) -> Tuple[int, Dict]:
        # pipelined responses coalesce into shared TCP segments, so one
        # recv routinely delivers the tail of this response plus the head
        # of the next — the leftover must survive in self._rbuf for the
        # next read instead of dying with a local buffer
        buf = self._rbuf
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed mid-response")
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0"))
        while len(rest) < n:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed mid-body")
            rest += chunk
        self._rbuf = rest[n:]
        if headers.get("connection", "").lower() == "close":
            self.close()
        return status, json.loads(rest[:n].decode("utf-8"))

    # -- typed endpoints ------------------------------------------------
    def _checked(self, method: str, path: str, payload: Any = None,
                 idempotent: bool = True,
                 headers: Optional[Dict[str, str]] = None,
                 raw_body: Optional[bytes] = None,
                 content_type: str = "application/json") -> Dict:
        status, out = self.request(method, path, payload,
                                   idempotent=idempotent, headers=headers,
                                   raw_body=raw_body,
                                   content_type=content_type)
        if status != 200 or not out.get("ok", False):
            raise TransportError(status, out.get("error", {}))
        return out

    def predict(self, req, deadline_ms: Optional[float] = None
                ) -> Dict[str, Any]:
        """``req``: a ``PredictRequest`` or an equivalent dict. Returns the
        result dict (latency_ms, mode, price_hr, epoch, ...).
        ``deadline_ms`` rides the ``X-Deadline-Ms`` header — the server
        sheds the request with a 504 if the budget elapses before it is
        planned."""
        if isinstance(req, PredictRequest):
            req = request_to_dict(req)
        headers = (None if deadline_ms is None
                   else {"X-Deadline-Ms": f"{float(deadline_ms):g}"})
        return self._checked("POST", "/predict", req,
                             headers=headers)["result"]

    def grid(self, req) -> Dict[str, Any]:
        if isinstance(req, GridRequest):
            req = dataclasses.asdict(req)
        return self._checked("POST", "/grid", req)

    def advise(self, payload: Dict[str, Any]) -> List[Dict[str, Any]]:
        return self._checked("POST", "/advise", payload)["rows"]

    def measure(self, rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Report a batch of client-measured latencies for live
        calibration. ``rows``: dicts with anchor/target/model/batch/pix/
        latency_ms (+ optional predicted_ms); sent as ONE columnar body.
        Returns ``{"accepted": n, "dropped": d}``.

        Codec negotiation: the first batch goes out binary columnar
        (``application/x-profet-columnar``); a 400/415 means the server
        rejected the body *before ingesting anything*, so falling back to
        the JSON codec (and remembering it) is double-ingest safe. The
        settled codec then also drives :meth:`measure_pipelined`.

        Non-idempotent: every delivery ingests the rows again, so a lost
        *response* (send completed, read failed) raises instead of
        re-sending — see :meth:`request`."""
        if self._measure_binary is not False:
            try:
                out = self._checked(
                    "POST", "/measure", idempotent=False,
                    raw_body=measure_binary_from_rows(rows),
                    content_type=COLUMNAR_CONTENT_TYPE)
                self._measure_binary = True
                return {"accepted": out["accepted"],
                        "dropped": out["dropped"]}
            except TransportError as e:
                if self._measure_binary or e.status not in (400, 415):
                    raise
                self._measure_binary = False
        out = self._checked("POST", "/measure",
                            measure_columnar_from_rows(rows),
                            idempotent=False)
        return {"accepted": out["accepted"], "dropped": out["dropped"]}

    def measure_pipelined(self, rows: Sequence[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
        """Fire a /measure batch without waiting for its response (see
        :meth:`send_pipelined`; the ack lands in :meth:`take_collected`
        under the tag ``"measure"``). The first batch on a fresh client
        negotiates the codec synchronously and returns its ack;
        subsequent calls return None."""
        if self._measure_binary is None:
            return self.measure(rows)
        if self._measure_binary:
            self.send_pipelined("POST", "/measure",
                                raw_body=measure_binary_from_rows(rows),
                                content_type=COLUMNAR_CONTENT_TYPE,
                                tag="measure")
        else:
            self.send_pipelined("POST", "/measure",
                                payload=measure_columnar_from_rows(rows),
                                tag="measure")
        return None

    def healthz(self) -> Dict[str, Any]:
        return self._checked("GET", "/healthz")

    def statsz(self) -> Dict[str, Any]:
        return self._checked("GET", "/statsz")


def request_to_dict(req: PredictRequest) -> Dict[str, Any]:
    return {"anchor": req.anchor, "target": req.target,
            "workload": dataclasses.asdict(req.workload),
            "profile": None if req.profile is None else dict(req.profile),
            "mode": req.mode, "knob": req.knob,
            "deadline_ms": req.deadline_ms}


def replay(host: str, port: int, requests: Sequence[PredictRequest],
           clients: int = 8, measure_fn=None,
           measure_every: int = 32,
           retry: Optional[RetryPolicy] = None) -> Dict[str, Any]:
    """Client-replay load generator: partition ``requests`` round-robin
    over ``clients`` threads (one keep-alive connection each) and fire them
    concurrently. Returns wall time, per-request client-side latencies, the
    responses in original request order, and any typed errors.

    ``measure_fn(request, result_dict) -> float | None`` simulates a client
    that actually ran its workload: a non-``None`` return is the measured
    latency, reported back through ``POST /measure`` in columnar batches of
    ``measure_every`` rows per thread (each row echoes the prediction it is
    scored against as ``predicted_ms``), driving live calibration."""
    results: List[Optional[Dict[str, Any]]] = [None] * len(requests)
    errors: List[Tuple[int, str]] = []
    lat_ms: List[float] = []
    lock = threading.Lock()
    measured = {"reported": 0, "dropped": 0, "pipelined": 0}

    def account(out: Optional[Dict[str, Any]]) -> None:
        if out is None:
            return
        with lock:
            measured["reported"] += out["accepted"]
            measured["dropped"] += out["dropped"]

    def flush(c: Client, rows: List[Dict[str, Any]]) -> None:
        """Fire the batch pipelined (no round-trip on the hot loop): the
        first batch negotiates the codec synchronously; later acks are
        read opportunistically whenever the connection next turns around
        and accounted from take_collected at the end."""
        if not rows:
            return
        try:
            out = c.measure_pipelined(rows)
        except (TransportError, ConnectionError, OSError):
            return
        finally:
            rows.clear()
        if out is None:
            with lock:
                measured["pipelined"] += 1
        account(out)

    def settle(c: Client) -> None:
        try:
            c.drain()
        except (ConnectionError, OSError):
            pass
        for tag, status, payload in c.take_collected():
            if tag == "measure" and status == 200 and payload.get("ok"):
                account(payload)

    def worker(offset: int) -> None:
        rows: List[Dict[str, Any]] = []
        with Client(host, port, retry=retry) as c:
            for i in range(offset, len(requests), clients):
                t0 = time.perf_counter()
                try:
                    res = c.predict(requests[i])
                except TransportError as e:
                    with lock:
                        errors.append((i, e.error_type))
                    continue
                dt = 1e3 * (time.perf_counter() - t0)
                with lock:
                    results[i] = res
                    lat_ms.append(dt)
                if measure_fn is None:
                    continue
                truth = measure_fn(requests[i], res)
                if truth is None:
                    continue
                w = res["workload"]
                rows.append({"anchor": res["anchor"],
                             "target": res["target"],
                             "model": w["model"], "batch": w["batch"],
                             "pix": w["pix"], "latency_ms": float(truth),
                             "predicted_ms": res["latency_ms"],
                             "epoch": res.get("epoch")})
                if len(rows) >= max(1, int(measure_every)):
                    flush(c, rows)
            flush(c, rows)
            settle(c)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(max(1, int(clients)))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    arr = np.array(lat_ms) if lat_ms else np.array([np.nan])
    return {"wall_s": wall, "n": len(requests), "clients": clients,
            "ok": sum(r is not None for r in results),
            "errors": errors, "results": results,
            "measured": measured["reported"],
            "measure_dropped": measured["dropped"],
            "measure_pipelined": measured["pipelined"],
            "client_p50_ms": float(np.nanpercentile(arr, 50)),
            "client_p99_ms": float(np.nanpercentile(arr, 99)),
            "latencies_ms": lat_ms,
            "requests_per_s": len(requests) / wall if wall else 0.0}

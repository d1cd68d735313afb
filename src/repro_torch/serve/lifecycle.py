"""``repro_torch.serve.lifecycle`` — worker leases + automatic respawn.

The shard plane contains worker death but never repairs it: a
dead worker's breaker key force-opens and its rows serve parent-side
forever, silently collapsing the multi-worker scaling the benches gate.
This module turns that permanent degradation into a bounded-time
recovery arc:

**Leases.** The supervisor turns the existing ``ping`` op into a
periodic heartbeat lease. A ping that fails to return within
``lease_timeout_s`` (or is lost at the ``shard.worker.lease`` fault
site) marks the worker **suspect**: ``ShardedBank.execute`` routes a
suspect shard's rows parent-side *before* a wave ever rides it — a
renewed lease clears the flag, ``dead_after_misses`` consecutive misses
hard-kill the worker and hand it to recovery.

**Respawn / reconnect.** A dead worker is replaced, never resurrected:
spawn workers are re-forked, thread personas re-instantiated, TCP
workers re-dialed (or re-launched through a ``TcpWorkerPool`` endpoint
callback when the subprocess itself died — the replacement lands on a
new ephemeral port). Attempts back off exponentially through the same
:class:`repro_torch.serve.resilience.RetryPolicy` arithmetic the HTTP client
uses, gated on the injectable clock so a respawn storm is testable with
fake time; the ``shard.respawn.fail`` fault site injects attempt
failures.

**Adoption.** Before a replacement serves a single row it receives a
fresh (authenticated) HELLO and a full re-ship of every generation that
is *live* at that instant — under the plane's swap lock, so a
concurrent ``oracle_refreshed`` either completes before the snapshot or
waits until after adoption. No wave can therefore meet a worker missing
its generation (no mixed epochs), answers stay bit-identical through
the whole recovery window (same tensors, whether a shard answers
worker-side or parent-side), and swaps keep counting only adopted
workers (a mid-recovery replacement is not in ``plane.workers`` yet —
the dead slot is skipped exactly like before). Adoption atomically
swaps the worker slot, heals that shard's breaker key
(:meth:`CircuitBreaker.heal` — the replacement shares no fate with the
process that died), and closes the old worker object so repeated
kill/respawn cycles leak no fds, shared-memory segments, or zombies.

States (surfaced through ``/healthz`` and ``/statsz``):

    live ──missed lease──▶ suspect ──dead_after_misses──▶ recovering
      ▲                      │ lease renewed                  │
      │                      ▼                                ▼
      └──next lease ok── adopted ◀──re-ship + adopt── (backoff loop)

Drive it synchronously (``step()`` with a fake clock — deterministic
tests) or as a daemon (``start()``/``stop()``, the serving default).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.serve import faults as faults_mod
from repro_torch.serve.resilience import RetryPolicy
from repro_torch.serve.shard import (ShardPlane, WorkerDeadError,
                               _release_segments)

LIVE = "live"
SUSPECT = "suspect"
RECOVERING = "recovering"
ADOPTED = "adopted"
DEAD = "dead"          # recovery gave up (max_attempts exhausted)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Supervision knobs. ``backoff`` shapes the respawn schedule (its
    ``max_attempts`` field is ignored — ``max_attempts`` here bounds
    attempts per death, ``None`` retries forever). ``endpoints`` maps a
    worker index to a zero-arg callable returning a fresh ``host:port``
    for its replacement (e.g. ``TcpWorkerPool.respawn``); workers
    without an entry are re-dialed at their old address."""
    lease_interval_s: float = 0.5
    lease_timeout_s: float = 2.0
    dead_after_misses: int = 3
    reship_timeout_s: float = 60.0
    backoff: RetryPolicy = RetryPolicy(
        max_attempts=2, base_s=0.05, multiplier=2.0, max_backoff_s=2.0,
        jitter=0.0, seed=0)
    max_attempts: Optional[int] = None
    endpoints: Optional[Dict[int, Callable[[], str]]] = None


class _WorkerState:
    def __init__(self):
        self.state = LIVE
        self.lease_at: Optional[float] = None   # clock of last renewal
        self.misses = 0                         # consecutive missed leases
        self.respawns = 0                       # successful adoptions
        self.attempt = 0                        # failed attempts this death
        self.next_attempt_at = 0.0
        self.last_error: Optional[str] = None
        self.gave_up = False


class WorkerSupervisor:
    """Self-healing supervision for one :class:`ShardPlane`. Attaches
    itself as ``plane.supervisor`` (telemetry rides ``plane.summary()``;
    ``plane.close()`` stops it)."""

    def __init__(self, plane: ShardPlane, *,
                 config: Optional[LifecycleConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 faults: Optional[faults_mod.FaultInjector] = None):
        self._plane = plane
        self._cfg = config or LifecycleConfig()
        self._clock = clock
        self._faults = faults
        self._rng = self._cfg.backoff.rng()
        self._states = [_WorkerState() for _ in range(plane.n_workers)]
        self._step_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        plane.supervisor = self

    # -- one synchronous supervision pass ------------------------------
    def step(self) -> None:
        """Lease every worker, then drive recovery for the dead ones.
        Deterministic under an injected clock — backoff gating compares
        against ``clock()``, and ``step`` itself never sleeps."""
        with self._step_lock:
            self.steps += 1
            for i in range(self._plane.n_workers):
                st = self._states[i]
                if st.gave_up:
                    continue
                w = self._plane.workers[i]
                if w.alive:
                    self._lease(i, w, st)
                if not self._plane.workers[i].alive:
                    self._recover(i, st)

    def _lease(self, i: int, w, st: _WorkerState) -> None:
        try:
            # an injected lease fault models a lost heartbeat (network
            # blip, paused worker): the ping never happens this round
            faults_mod.fire(self._faults, faults_mod.SITE_SHARD_LEASE)
            w.submit(("ping",)).result(timeout=self._cfg.lease_timeout_s)
        except WorkerDeadError:
            return               # dead: the recovery pass takes over
        except Exception as e:   # FutureTimeout, InjectedFault, err reply
            st.misses += 1
            st.state = SUSPECT
            st.last_error = f"lease: {type(e).__name__}: {e}"
            w.suspect = True     # waves route this shard parent-side
            if st.misses >= self._cfg.dead_after_misses:
                # a worker that stopped answering leases is declared
                # dead: kill the channel so recovery can replace it
                w.kill()
            return
        st.lease_at = self._clock()
        st.misses = 0
        if w.suspect:
            w.suspect = False
        st.state = LIVE

    def _recover(self, i: int, st: _WorkerState) -> None:
        st.state = RECOVERING
        if self._cfg.max_attempts is not None \
                and st.attempt >= self._cfg.max_attempts:
            st.gave_up = True
            st.state = DEAD
            return
        now = self._clock()
        if now < st.next_attempt_at:
            return               # still backing off
        new_w = None
        try:
            faults_mod.fire(self._faults, faults_mod.SITE_RESPAWN_FAIL)
            address = None
            ep = (self._cfg.endpoints or {}).get(i)
            if ep is not None:
                address = ep()   # e.g. TcpWorkerPool.respawn -> new port
            new_w = self._plane.build_worker(i, address=address)
            self._reship_and_adopt(i, new_w)
        except Exception as e:
            if new_w is not None:
                try:
                    new_w.close()
                except Exception:
                    pass
            st.attempt += 1
            st.last_error = f"respawn: {type(e).__name__}: {e}"
            st.next_attempt_at = now + self._cfg.backoff.backoff_s(
                st.attempt, self._rng)
            return
        st.state = ADOPTED       # -> LIVE on its next renewed lease
        st.respawns += 1
        st.attempt = 0
        st.next_attempt_at = 0.0
        st.misses = 0
        st.last_error = None
        st.lease_at = self._clock()

    def _reship_and_adopt(self, i: int, new_w) -> None:
        """Ship every live generation's shard to the replacement, then
        adopt it — all under the plane's swap lock, so a concurrent
        ``oracle_refreshed`` load cannot interleave: whatever is live at
        adoption time is exactly what the replacement holds."""
        plane = self._plane
        with plane._swap_lock:
            shipped: List[int] = []
            for gen in plane.live_generations():
                sub = gen.sub_bank(i)
                if sub is None:
                    continue
                op, segs = new_w.prepare_load(gen.gen_id, sub)
                try:
                    new_w.submit(op).result(
                        timeout=self._cfg.reship_timeout_s)
                except Exception:
                    _release_segments(segs, unlink=True)
                    raise
                with plane._lock:
                    if gen.dropped:
                        # retired AND dropped mid-ship: the generation's
                        # own segment list was already unlinked — ours
                        # would leak if we appended now
                        _release_segments(segs, unlink=True)
                    else:
                        gen.segments.extend(segs)
                shipped.append(gen.gen_id)
            plane.adopt_worker(i, new_w)
            # a generation that finished retiring mid-ship sent its
            # worker-side drops to the OLD (dead) slot — free the
            # adoptee's copy explicitly
            with plane._lock:
                stale = [g for g in shipped
                         if g not in plane._gens
                         or plane._gens[g].dropped]
            for gid in stale:
                new_w.submit(("drop", gid))

    # -- daemon mode ---------------------------------------------------
    def start(self, interval_s: Optional[float] = None
              ) -> "WorkerSupervisor":
        if self._thread is not None:
            return self
        interval = (self._cfg.lease_interval_s
                    if interval_s is None else float(interval_s))
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.step()
                except Exception:
                    # supervision must outlive a bad pass (e.g. a race
                    # with plane.close mid-step); the next tick retries
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="shard-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    # -- telemetry -----------------------------------------------------
    def summary(self) -> dict:
        now = self._clock()
        workers = []
        counts: Dict[str, int] = {}
        for i, st in enumerate(self._states):
            w = self._plane.workers[i]
            state = st.state
            counts[state] = counts.get(state, 0) + 1
            workers.append({
                "index": i,
                "kind": w.kind,
                "state": state,
                "alive": w.alive,
                "lease_age_s": (None if st.lease_at is None
                                else max(now - st.lease_at, 0.0)),
                "misses": st.misses,
                "respawns": st.respawns,
                "attempt": st.attempt,
                "last_error": st.last_error,
            })
        return {"workers": workers, "states": counts,
                "respawns": sum(s.respawns for s in self._states),
                "steps": self.steps,
                "supervising": self._thread is not None}

"""Bounded streaming buffer of client-measured latencies.

The ingest stage of the calibration loop: every accepted
:class:`~repro_torch.calibrate.types.Observation` lands in a
per-(anchor, target) ring buffer (``deque(maxlen=...)``), so memory is
bounded per pair AND in the number of pairs, and a drifting pair always
holds its *freshest* ground truth — old observations fall off the back.
Every drop is accounted: ``evicted`` (ring overwrote the oldest),
``rejected`` (pair table full / non-finite latency / pair the attached
oracle can never serve).

Lock-guarded: the transport's event loop ingests while the controller
thread reads snapshots.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.calibrate.types import Observation, Pair


class MeasurementBuffer:
    """Per-pair ring buffers with drop accounting."""

    def __init__(self, per_pair: int = 512, max_pairs: int = 64,
                 allowed_pairs: Optional[Set[Pair]] = None):
        self.per_pair = int(per_pair)
        self.max_pairs = int(max_pairs)
        # None = accept any pair; a set restricts ingest to pairs the
        # serving oracle can actually answer (plus target==anchor rows)
        self.allowed_pairs = allowed_pairs
        self._rings: Dict[Pair, deque] = {}
        self._lock = threading.Lock()
        self.evicted = 0
        self.rejected = 0

    # ------------------------------------------------------------------
    def _acceptable(self, obs: Observation) -> bool:
        if not math.isfinite(obs.latency_ms) or obs.latency_ms <= 0:
            return False
        if self.allowed_pairs is not None and obs.anchor != obs.target \
                and obs.pair not in self.allowed_pairs:
            return False
        return True

    def add(self, obs: Observation) -> bool:
        """Ingest one observation; returns whether it was accepted."""
        if not self._acceptable(obs):
            with self._lock:
                self.rejected += 1
            return False
        with self._lock:
            ring = self._rings.get(obs.pair)
            if ring is None:
                if len(self._rings) >= self.max_pairs:
                    self.rejected += 1
                    return False
                ring = self._rings[obs.pair] = deque(maxlen=self.per_pair)
            if len(ring) == self.per_pair:
                self.evicted += 1
            ring.append(obs)
        return True

    def add_many(self, observations: Sequence[Observation]
                 ) -> Tuple[int, int]:
        """Returns (accepted, dropped)."""
        accepted = sum(1 for o in observations if self.add(o))
        return accepted, len(observations) - accepted

    # ------------------------------------------------------------------
    def pairs(self) -> List[Pair]:
        with self._lock:
            return sorted(self._rings)

    def count(self, pair: Pair) -> int:
        with self._lock:
            ring = self._rings.get(pair)
            return len(ring) if ring is not None else 0

    def observations(self, pair: Pair,
                     last: Optional[int] = None) -> List[Observation]:
        """Snapshot copy, oldest first; ``last`` keeps only the freshest
        N (refits and canary scoring window on the current regime)."""
        with self._lock:
            ring = self._rings.get(pair)
            obs = list(ring) if ring is not None else []
        return obs if last is None else obs[-int(last):]

    def total(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._rings.values())

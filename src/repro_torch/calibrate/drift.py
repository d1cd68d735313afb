"""Per-pair drift detection: rolling MAPE of live predictions vs
client-measured latencies, with a trigger threshold and hysteresis.

Each scored observation contributes one absolute-percentage-error sample
to its pair's rolling window. A pair becomes *drifted* when its rolling
MAPE exceeds ``trigger_mape`` over at least ``min_obs`` samples, and
clears only when it falls below ``trigger_mape * clear_ratio`` — the
hysteresis band that stops a pair sitting at the threshold from flapping
the refit machinery on every wave.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.calibrate.types import Pair


class DriftDetector:
    def __init__(self, window: int = 64, min_obs: int = 8,
                 trigger_mape: float = 15.0, clear_ratio: float = 0.6):
        self.window = int(window)
        self.min_obs = int(min_obs)
        self.trigger_mape = float(trigger_mape)
        self.clear_mape = float(trigger_mape) * float(clear_ratio)
        self._ape: Dict[Pair, deque] = {}
        self._drifted: Dict[Pair, bool] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def update(self, pair: Pair, measured_ms: float,
               predicted_ms: float) -> Optional[bool]:
        """Fold one scored observation in. Returns ``True`` the moment the
        pair *transitions* to drifted, ``False`` the moment it clears,
        ``None`` when its state did not change."""
        ape = 100.0 * abs(predicted_ms - measured_ms) / max(
            abs(measured_ms), 1e-12)
        with self._lock:
            ring = self._ape.get(pair)
            if ring is None:
                ring = self._ape[pair] = deque(maxlen=self.window)
            ring.append(ape)
            mape = float(np.mean(ring))
            was = self._drifted.get(pair, False)
            if not was and len(ring) >= self.min_obs \
                    and mape > self.trigger_mape:
                self._drifted[pair] = True
                return True
            if was and mape < self.clear_mape:
                self._drifted[pair] = False
                return False
            return None

    # ------------------------------------------------------------------
    def mape(self, pair: Pair) -> float:
        with self._lock:
            ring = self._ape.get(pair)
            return float(np.mean(ring)) if ring else float("nan")

    def samples(self, pair: Pair) -> int:
        with self._lock:
            ring = self._ape.get(pair)
            return len(ring) if ring is not None else 0

    def is_drifted(self, pair: Pair) -> bool:
        with self._lock:
            return self._drifted.get(pair, False)

    def drifted_pairs(self) -> List[Pair]:
        with self._lock:
            return sorted(p for p, d in self._drifted.items() if d)

    def rolling(self) -> Dict[Pair, float]:
        """Snapshot of every tracked pair's rolling MAPE."""
        with self._lock:
            return {p: float(np.mean(r)) for p, r in self._ape.items() if r}

    def reset(self, pairs: Optional[Iterable[Pair]] = None) -> None:
        """Drop the rolling windows (and drifted state) of ``pairs`` —
        called after an epoch transition, when the predictions the old
        window was scored against no longer serve."""
        with self._lock:
            for p in (list(self._ape) if pairs is None else pairs):
                self._ape.pop(p, None)
                self._drifted.pop(p, None)

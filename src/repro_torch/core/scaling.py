"""Batch-size / input-pixel-size scaling predictor (paper §III-C2).

Per instance type: latencies of each (model, pixel) group are min-max
normalized between the group's min-config and max-config latency; a single
second-order polynomial T_N(b) = a2 b^2 + a1 b + a0 is fit per instance over
all groups; prediction denormalizes with Eq. 1:

    T_O(b) = T_N(b) * (T_O(max) - T_O(min)) + T_O(min)

The min/max latencies come either from true measurements ("True" mode, ~5%
MAPE in the paper) or from the cross-instance predictor ("Predict" mode,
~11% MAPE).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PolyScaler:
    """Min-max + polynomial regression in the scaled coordinate.

    Groups whose max-config latency is within ``min_range`` of the min-config
    latency are excluded from the fit: a near-flat series (e.g. a small model
    on V100 where occupancy never saturates — the paper's Fig-2c case) has no
    usable normalized shape, and dividing by its ~0 range would poison the
    regression with 1e9-scale targets.
    """
    order: int = 2
    min_knob: float = 16.0
    max_knob: float = 256.0
    min_range: float = 0.05   # relative (hi-lo)/lo below which a group is flat
    coef: np.ndarray = None  # highest-order first (np.polyfit layout)

    def _norm_knob(self, b):
        return (np.asarray(b, np.float64) - self.min_knob) / \
            (self.max_knob - self.min_knob)

    def fit(self, knobs: np.ndarray, lat: np.ndarray,
            groups: np.ndarray) -> "PolyScaler":
        """knobs: (N,) batch/pixel values; lat: (N,) latencies; groups: (N,)
        group ids — each group is one (model, other-knob, instance) series
        that must contain the min and max knob configs."""
        knobs = np.asarray(knobs, np.float64)
        lat = np.asarray(lat, np.float64)
        xs, ys = [], []
        for g in np.unique(groups):
            m = groups == g
            kb, lt = knobs[m], lat[m]
            try:
                lo = lt[kb == self.min_knob][0]
                hi = lt[kb == self.max_knob][0]
            except IndexError:
                continue
            if hi - lo <= self.min_range * abs(lo):
                continue  # flat series: no normalized shape to learn
            xs.append(self._norm_knob(kb))
            ys.append((lt - lo) / (hi - lo))
        if not xs:  # degenerate dataset: identity-ish linear ramp
            self.coef = np.zeros(self.order + 1)
            self.coef[-2] = 1.0
            return self
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        self.coef = np.polyfit(x, y, self.order)
        return self

    def predict_normalized(self, knob) -> np.ndarray:
        return np.polyval(self.coef, self._norm_knob(knob))

    def predict(self, knob, t_min, t_max) -> np.ndarray:
        """Eq. 1 denormalization given the min/max-config latencies."""
        tn = self.predict_normalized(knob)
        return tn * (np.asarray(t_max) - np.asarray(t_min)) + np.asarray(t_min)

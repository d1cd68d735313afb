"""Shadow-canary scoring: candidate vs incumbent on held-out live truth.

The promote gate of the calibration loop. Two signals feed the verdict:

  - **held-out MAPE** — every buffered pair with enough observations is
    re-predicted by BOTH oracles (one ``predict_many`` batch each, off the
    serving path) and scored against the client-measured latencies. The
    candidate must strictly improve every pair it was refit on and may not
    regress any other pair by more than ``regress_margin`` points;
  - **shadow waves** — mirrored slices of live waves the controller
    replayed on the candidate. Any candidate-side execution error is an
    instant fail: a model that crashes on real traffic shapes never
    reaches ``oracle_refreshed``.

Each ``predict_many`` runs through that oracle's own bank on its device:
on the card, one fused grouped forest launch per oracle and scored pair.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.types import ApiError, PredictRequest, Workload
from repro_torch.calibrate.types import Pair, pair_label
from repro_torch.core.ensemble import mape


@dataclasses.dataclass(frozen=True)
class CanaryReport:
    """Verdict of one shadow canary. ``pair_scores`` maps each scored pair
    to ``(incumbent_mape, candidate_mape, n_obs)``."""
    passed: bool
    reason: str
    pair_scores: Dict[Pair, Tuple[float, float, int]]
    shadow_waves: int = 0
    shadow_requests: int = 0
    shadow_errors: int = 0

    def summary(self) -> Dict[str, object]:
        return {"passed": self.passed, "reason": self.reason,
                "pairs": {pair_label(p): {"incumbent_mape": s[0],
                                          "candidate_mape": s[1],
                                          "n_obs": s[2]}
                          for p, s in self.pair_scores.items()},
                "shadow_waves": self.shadow_waves,
                "shadow_requests": self.shadow_requests,
                "shadow_errors": self.shadow_errors}


def heldout_scores(incumbent, candidate, buffer,
                   pairs: Optional[Sequence[Pair]] = None,
                   min_obs: int = 1, window: Optional[int] = None
                   ) -> Dict[Pair, Tuple[float, float, int]]:
    """Per-pair (incumbent, candidate) MAPE vs the buffer's measurements
    (the freshest ``window`` per pair when given — score on the current
    regime). Pairs with fewer than ``min_obs`` scoreable observations are
    skipped; so are observations whose case the anchor never profiled
    (off-grid two-phase traffic — no deterministic cross request
    reproduces them)."""
    scores: Dict[Pair, Tuple[float, float, int]] = {}
    for pair in (buffer.pairs() if pairs is None else pairs):
        anchor, _ = pair
        profiled = incumbent.dataset.measurements.get(anchor, {})
        obs = [o for o in buffer.observations(pair, last=window)
               if o.case in profiled]
        if len(obs) < min_obs:
            continue
        reqs = [PredictRequest(o.anchor, o.target,
                               Workload.from_case(o.case)) for o in obs]
        try:
            inc = incumbent.predict_many(reqs).latencies()
            cand = candidate.predict_many(reqs).latencies()
        except ApiError:
            continue
        meas = np.array([o.latency_ms for o in obs])
        scores[pair] = (mape(meas, inc), mape(meas, cand), len(obs))
    return scores


def verdict(incumbent, candidate, buffer, refit_pairs: Sequence[Pair], *,
            min_obs: int = 4, regress_margin: float = 1.0,
            window: Optional[int] = None, shadow_waves: int = 0,
            shadow_requests: int = 0,
            shadow_errors: int = 0) -> CanaryReport:
    """Combine shadow execution health and held-out scores into the
    promote/discard decision."""
    scores = heldout_scores(incumbent, candidate, buffer, min_obs=min_obs,
                            window=window)

    def report(passed: bool, reason: str) -> CanaryReport:
        return CanaryReport(passed=passed, reason=reason,
                            pair_scores=scores, shadow_waves=shadow_waves,
                            shadow_requests=shadow_requests,
                            shadow_errors=shadow_errors)

    if shadow_errors:
        return report(False, f"candidate failed {shadow_errors} shadow "
                             "execution(s) on mirrored live traffic")
    refit_scored = [p for p in refit_pairs if p in scores]
    if not refit_scored:
        return report(False, "no held-out observations cover the refit "
                             "pairs — cannot establish improvement")
    for p in refit_scored:
        inc, cand, n = scores[p]
        if not cand < inc:
            return report(False, f"refit pair {pair_label(p)} did not "
                                 f"improve ({cand:.2f} vs {inc:.2f} MAPE "
                                 f"over {n} obs)")
    for p, (inc, cand, n) in scores.items():
        if p in refit_scored:
            continue
        if cand > inc + regress_margin:
            return report(False, f"pair {pair_label(p)} regressed "
                                 f"({cand:.2f} vs {inc:.2f} MAPE over "
                                 f"{n} obs)")
    worst = max((scores[p][1] for p in refit_scored))
    return report(True, "candidate improves every refit pair (worst "
                        f"candidate MAPE {worst:.2f}) without regressing "
                        "the rest")

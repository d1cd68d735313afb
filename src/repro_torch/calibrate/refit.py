"""Per-pair background refits: drifted ensembles rebuilt on live truth.

A drifted (anchor, target) pair is refit through the fast vectorized
``MedianEnsemble.fit`` path on a *patched* latency vector: the offline
dataset's target latencies are first scaled by the median live-vs-offline
ratio of the observed cases (a fleet-wide slowdown shows up on every
config, not just the ones traffic happened to cover — the Habitat-style
runtime-ratio extrapolation), then every case with live observations is
overwritten with its observed mean. Features stay the incumbent's — the
candidate shares the fitted op-name clustering and phase-2 scalers, so
its ensembles drop into a clone of the incumbent oracle
(:meth:`repro_torch.api.LatencyOracle.clone_with_pairs`) and the whole
candidate banks/stacks/swaps exactly like a from-scratch fit.

The candidate's ensembles are fit on the incumbent's device
(``oracle.profet.device``), never on ``MedianEnsemble``'s default: a
candidate of a CPU oracle stays on the CPU, and one bank never holds
members of two devices. The linear and forest members are fit on the
host in float64, so they are the same on every device; the DNN member
trains on that device.

Nothing here touches the serving epoch: the candidate is a fresh
``LatencyOracle`` the controller shadow-scores before any swap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calibrate.buffer import MeasurementBuffer
from repro_torch.calibrate.types import Pair
from repro_torch.core.ensemble import MedianEnsemble


@dataclasses.dataclass(frozen=True)
class RefitReport:
    """What one candidate build actually did, pair by pair."""
    pairs: Tuple[Pair, ...]            # pairs whose ensembles were rebuilt
    skipped: Tuple[Pair, ...]          # drifted but too few usable obs
    scale: Dict[Pair, float]           # live-vs-offline median ratio applied
    n_obs: Dict[Pair, int]             # usable observations folded in
    total_obs: int = 0


def calibrated_latencies(dataset, target: str, cases: Sequence,
                         observations) -> Tuple[np.ndarray, float, int]:
    """The patched phase-1 training targets for one pair: offline latencies
    scaled by the median observed/offline ratio, observed cases overwritten
    with their live means. Returns ``(y, scale, n_usable)``."""
    measured = dataset.measurements[target]
    y = np.array([dataset.latency(target, c) for c in cases], np.float64)
    by_case: Dict[tuple, List[float]] = {}
    for o in observations:
        if o.case in measured:          # off-grid cases have no offline row
            by_case.setdefault(o.case, []).append(o.latency_ms)
    if not by_case:
        return y, 1.0, 0
    obs_mean = {c: float(np.mean(v)) for c, v in by_case.items()}
    ratios = [obs_mean[c] / dataset.latency(target, c) for c in obs_mean]
    scale = float(np.median(ratios))
    y = y * scale
    case_pos = {c: i for i, c in enumerate(cases)}
    for c, m in obs_mean.items():
        if c in case_pos:
            y[case_pos[c]] = m
    return y, scale, sum(len(v) for v in by_case.values())


def build_candidate(oracle, buffer: MeasurementBuffer,
                    pairs: Sequence[Pair], *, min_refit_obs: int = 4,
                    window: Optional[int] = None
                    ) -> Tuple[Optional[object], RefitReport]:
    """Refit ``pairs`` of ``oracle`` on the buffer's live truth; returns
    ``(candidate_oracle, report)``. ``candidate_oracle`` is ``None`` when
    no pair had enough usable observations (nothing to promote).

    Only trained cross pairs are refittable — a drifted ``(a, a)``
    measured-mode pair means the offline dataset itself is stale, which a
    phase-1 refit cannot fix (it surfaces in stats instead).

    ``window`` restricts each pair to its freshest N observations so the
    refit trains on the post-drift regime, not on a blend with stale
    pre-drift truth still sitting in the ring.
    """
    cfg = oracle.config
    ds = oracle.dataset
    trained = set(oracle.pairs())
    cases = list(ds.cases)
    overrides: Dict[Pair, MedianEnsemble] = {}
    skipped: List[Pair] = []
    scale: Dict[Pair, float] = {}
    n_obs: Dict[Pair, int] = {}
    for pair in pairs:
        anchor, target = pair
        obs = buffer.observations(pair, last=window)
        if pair not in trained:
            skipped.append(pair)
            continue
        y, s, n = calibrated_latencies(ds, target, cases, obs)
        if n < min_refit_obs:
            skipped.append(pair)
            continue
        X = oracle.feature_matrix(anchor, cases)
        overrides[pair] = MedianEnsemble(
            seed=cfg.seed, dnn_epochs=cfg.dnn_epochs, n_trees=cfg.n_trees,
            members=cfg.members, device=oracle.profet.device).fit(X, y)
        scale[pair] = s
        n_obs[pair] = n
    report = RefitReport(pairs=tuple(sorted(overrides)),
                         skipped=tuple(sorted(skipped)), scale=scale,
                         n_obs=n_obs, total_obs=sum(n_obs.values()))
    if not overrides:
        return None, report
    return oracle.clone_with_pairs(overrides), report

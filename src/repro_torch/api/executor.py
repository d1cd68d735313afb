"""Fused batch executor: ``Sequence[PredictPlan]`` -> ``BatchPredictResult``.

Stages 2+3 of the plan -> batch -> execute pipeline. A heterogeneous plan
list (measured + cross + two-phase, any mix of device pairs) is answered
in one pass:

  1. **gather** — every phase-1 row any plan needs is registered per anchor
     and deduplicated by (profile content, case): a cross plan contributes
     its own row, a two-phase plan contributes its oracle-chosen min/max
     config rows.  Grid sweeps and repeated requests collapse onto shared
     rows for free, including equal-by-value client-supplied profiles.
  2. **batch** — ONE feature matrix per anchor over its deduped rows, then
     a group id per (anchor, target) pair.
  3. **execute** — with a :class:`repro_torch.api.bank.ModelBank` the WHOLE wave
     is one stacked dispatch: one grouped forest launch + one stacked MLP
     apply + row-stable linear/median, however many device pairs the wave
     mixes (``fused_calls == 1``). Without a bank (or when the bank cannot
     serve the wave's pairs) each (anchor, target) group falls back to its
     own fused ``MedianEnsemble.predict`` call. Two-phase plans then
     interpolate vectorized — one Horner pass over all rows (bank) or one
     ``PolyScaler.predict`` per (target, knob) group (fallback).

Both paths are bit-identical for the float64 members (routing gathers,
row-stable linear evaluation, tree-sequential forest mean, Horner ==
polyval) — ``benchmarks/bench_bank.py`` asserts it on every run.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.types import (BatchPredictResult, MODE_CROSS, MODE_MEASURED,
                             MODE_TWO_PHASE, PartialExecutionError,
                             PredictPlan, PredictResult, ShardExecutionError,
                             UnsupportedRequestError)


def _result(plan: PredictPlan, latency_ms: float,
            epoch: Optional[str]) -> PredictResult:
    return PredictResult(latency_ms=float(latency_ms),
                         anchor=plan.anchor, target=plan.target,
                         workload=plan.workload, mode=plan.mode,
                         price_hr=plan.price_hr, epoch=epoch)


def _profile_key(profile) -> tuple:
    """Stable content identity of a profile mapping. ``id(profile)`` is NOT
    usable: CPython reuses addresses, so a transient dict (e.g. a client
    profile decoded from a ``/predict`` payload) can alias a previously
    registered one after GC and silently share its row."""
    return tuple(sorted(profile.items()))


class _RowRegistry:
    """Deduplicated phase-1 rows, per anchor, plus the per-(anchor, target)
    row groups the executor batches over."""

    def __init__(self):
        self.index: Dict[str, Dict[tuple, int]] = {}    # anchor -> key -> row
        self.profiles: Dict[str, list] = {}
        self.cases: Dict[str, list] = {}
        self.groups: Dict[Tuple[str, str], list] = {}   # pair -> ordered keys
        self._in_group: Dict[Tuple[str, str], set] = {}
        # content keys memoized per object; the memo holds the profile
        # itself so an id can never be reused (and thus never alias) while
        # this registry lives — the failure mode of keying rows by id()
        # alone.
        self._key_memo: Dict[int, tuple] = {}

    def add(self, anchor: str, target: str, profile, case) -> tuple:
        """Register one needed row; returns its dedup key."""
        memo = self._key_memo.get(id(profile))
        if memo is None:
            memo = (profile, _profile_key(profile))
            self._key_memo[id(profile)] = memo
        key = (memo[1], case)
        rows = self.index.setdefault(anchor, {})
        if key not in rows:
            rows[key] = len(rows)
            self.profiles.setdefault(anchor, []).append(profile)
            self.cases.setdefault(anchor, []).append(case)
        pair = (anchor, target)
        seen = self._in_group.setdefault(pair, set())
        if key not in seen:
            seen.add(key)
            self.groups.setdefault(pair, []).append(key)
        return key

    @property
    def n_rows(self) -> int:
        return sum(len(r) for r in self.index.values())


def execute_plans(profet, plans: Sequence[PredictPlan],
                  epoch: Optional[str] = None,
                  bank=None) -> BatchPredictResult:
    """Answer every plan with the minimum number of fused model dispatches:
    ONE stacked dispatch for the whole wave when ``bank`` (a fitted
    :class:`repro_torch.api.bank.ModelBank`) covers its pairs, else one fused
    ensemble call per (anchor, target) pair. ``epoch`` — the oracle
    generation executing the batch — is stamped on every result so a
    serving layer's refresh swaps are observable per response."""
    n = len(plans)
    lat = np.full(n, np.nan)
    reg = _RowRegistry()
    cross_key: List[tuple] = [None] * n
    tp_keys: List[tuple] = [None] * n
    mode_counts: Dict[str, int] = {}

    for i, plan in enumerate(plans):
        mode_counts[plan.mode] = mode_counts.get(plan.mode, 0) + 1
        if plan.mode == MODE_MEASURED:
            lat[i] = plan.measured_ms
        elif plan.mode == MODE_CROSS:
            cross_key[i] = reg.add(plan.anchor, plan.target, plan.profile,
                                   plan.workload.case)
        elif plan.mode == MODE_TWO_PHASE:
            tp_keys[i] = (
                reg.add(plan.anchor, plan.target, plan.profile_min,
                        plan.case_min),
                reg.add(plan.anchor, plan.target, plan.profile_max,
                        plan.case_max))
        else:
            raise UnsupportedRequestError(
                f"plan with unresolved mode {plan.mode!r}")

    # one feature matrix per anchor over its deduped rows
    X = {anchor: profet.feature_matrix(reg.profiles[anchor],
                                       reg.cases[anchor])
         for anchor in reg.index}

    banked = (bank is not None and bool(reg.groups)
              and bank.supports(reg.groups))
    phase1: Dict[Tuple[str, str, tuple], float] = {}
    failed_keys: set = set()
    shard_error: Optional[str] = None
    fused = 0
    if banked:
        # stacked single-dispatch path: one grouped forest launch + one
        # stacked MLP apply for the whole wave
        rows, gids, flat_keys = [], [], []
        for (anchor, target), keys in reg.groups.items():
            idx = np.array([reg.index[anchor][k] for k in keys])
            rows.append(X[anchor][idx])
            gids.append(np.full(len(keys), bank.gid[(anchor, target)],
                                np.int64))
            flat_keys.extend((anchor, target, k) for k in keys)
        try:
            pred = bank.execute(np.concatenate(rows), np.concatenate(gids))
        except PartialExecutionError as e:
            # a sharded bank lost a slice mid-wave: keep every answered
            # row, mark the failed rows' keys so only the plans riding
            # them error out (typed, per-request) instead of the wave
            pred = e.preds
            shard_error = str(e)
            failed_keys = {fk for fk, bad in zip(flat_keys, e.failed_rows)
                           if bad}
        fused = 1
        for fk, v in zip(flat_keys, pred):
            if fk not in failed_keys:
                phase1[fk] = float(v)
    else:
        # per-group fallback: one fused ensemble call per (anchor, target)
        for (anchor, target), keys in reg.groups.items():
            idx = np.array([reg.index[anchor][k] for k in keys])
            pred = profet.predict_cross_matrix(anchor, target, X[anchor][idx])
            fused += 1
            for k, v in zip(keys, pred):
                phase1[(anchor, target, k)] = float(v)

    # scatter cross answers; collect two-phase rows. A plan errors (typed,
    # per-request) iff any phase-1 row it rides was on a failed shard
    # slice — for two-phase that means either endpoint.
    errors: List[Optional[ShardExecutionError]] = [None] * n

    def _slice_error(plan: PredictPlan) -> ShardExecutionError:
        return ShardExecutionError(
            f"shard slice for pair ({plan.anchor!r} -> {plan.target!r}) "
            f"failed mid-wave: {shard_error}")

    tp_rows: List[Tuple[int, PredictPlan]] = []
    for i, plan in enumerate(plans):
        if plan.mode == MODE_CROSS:
            fk = (plan.anchor, plan.target, cross_key[i])
            if fk in failed_keys:
                errors[i] = _slice_error(plan)
            else:
                lat[i] = phase1[fk]
        elif plan.mode == MODE_TWO_PHASE:
            k_min, k_max = tp_keys[i]
            if failed_keys and (
                    (plan.anchor, plan.target, k_min) in failed_keys
                    or (plan.anchor, plan.target, k_max) in failed_keys):
                errors[i] = _slice_error(plan)
            else:
                tp_rows.append((i, plan))
    if tp_rows:
        if banked:
            # one Horner pass over every two-phase row, any (target, knob)
            ii = np.array([i for i, _ in tp_rows])
            vals = np.array([p.knob_value for _, p in tp_rows])
            kinds = [p.request.knob for _, p in tp_rows]
            dev = np.array([bank.dev_id[p.target] for _, p in tp_rows])
            t_min = np.array([phase1[(p.anchor, p.target, tp_keys[i][0])]
                              for i, p in tp_rows])
            t_max = np.array([phase1[(p.anchor, p.target, tp_keys[i][1])]
                              for i, p in tp_rows])
            lat[ii] = bank.interpolate(kinds, dev, vals, t_min, t_max)
        else:
            tp_groups: Dict[Tuple[str, str], list] = {}
            for i, plan in tp_rows:
                k_min, k_max = tp_keys[i]
                tp_groups.setdefault(
                    (plan.target, plan.request.knob), []).append(
                        (i, plan.knob_value,
                         phase1[(plan.anchor, plan.target, k_min)],
                         phase1[(plan.anchor, plan.target, k_max)]))
            for (target, knob), rows_ in tp_groups.items():
                ii = np.array([r[0] for r in rows_])
                vals = np.array([r[1] for r in rows_])
                t_min = np.array([r[2] for r in rows_])
                t_max = np.array([r[3] for r in rows_])
                lat[ii] = profet.predict_knob(target, knob, vals,
                                              t_min, t_max)

    results = tuple(None if errors[i] is not None
                    else _result(p, lat[i], epoch)
                    for i, p in enumerate(plans))
    return BatchPredictResult(results=results, fused_calls=fused,
                              rows=reg.n_rows, mode_counts=mode_counts,
                              epoch=epoch, banked=banked,
                              errors=tuple(errors) if failed_keys else None)

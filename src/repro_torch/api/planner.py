"""Pure request planner: ``PredictRequest`` -> ``PredictPlan``.

Stage 1 of the plan -> batch -> execute pipeline behind ``LatencyOracle``.
Planning touches only plain data — the offline dataset (for anchor profiles
and the measured-case index), the set of trained ``(anchor, target)`` pairs,
and the device catalog (for prices) — never the fitted model. That keeps it
unit-testable with a stub dataset and lets a serving layer plan each request
individually (catching per-request ``ApiError``) before handing the valid
plans to one fused executor call.

All routing validation happens here, in a fixed order that matches the
pre-refactor ``LatencyOracle.predict``:

  1. anchor must be in the dataset             -> ``UnknownDeviceError``
  2. target == anchor needs a measured case    -> ``UnsupportedRequestError``
  3. (anchor, target) must be a trained pair   -> ``UnknownDeviceError``
  4. mode resolution (``auto`` routes on profile availability)
  5. cross needs an exact-case profile         -> ``UnsupportedRequestError``
     two-phase needs measured min/max configs  -> ``UnsupportedRequestError``
  6. the target must have a catalog price      -> ``UnknownDeviceError``
     (checked at plan time so cost columns can never be silently NaN)
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core import devices as device_catalog
from repro_torch.core import workloads
from repro_torch.api.types import (ANCHOR_ANY, KNOB_BATCH, KNOB_PIXEL, MODE_AUTO,
                             MODE_CROSS, MODE_MEASURED, MODE_TWO_PHASE,
                             PredictPlan, PredictRequest, UnknownDeviceError,
                             UnsupportedRequestError, Workload)

Case = Tuple[str, int, int]


def resolve_price(name: str) -> float:
    """Hourly price from the device catalog; raises instead of returning
    NaN so a missing catalog entry surfaces at plan time, not as a silent
    NaN cost column."""
    dev = device_catalog.CATALOG.get(name)
    if dev is None:
        raise UnknownDeviceError(
            f"device {name!r} has no catalog entry (price unknown); "
            f"catalog: {', '.join(sorted(device_catalog.CATALOG))}")
    return dev.price_hr


def minmax_cases(workload: Workload, knob: str,
                 measured: Mapping[Case, object]) -> Optional[Tuple[Case, Case]]:
    """The (lo, hi) anchor configs two-phase interpolation rests on: the
    workload with ``knob`` swung to the grid min/max. ``None`` if either
    config is missing from ``measured`` (the anchor's case index)."""
    m = workload.model
    if knob == KNOB_BATCH:
        lo = (m, min(workloads.BATCHES), workload.pix)
        hi = (m, max(workloads.BATCHES), workload.pix)
    elif knob == KNOB_PIXEL:
        lo = (m, workload.batch, min(workloads.PIXELS))
        hi = (m, workload.batch, max(workloads.PIXELS))
    else:
        raise UnsupportedRequestError(f"unknown knob {knob!r}")
    if lo in measured and hi in measured:
        return lo, hi
    return None


def partition_pairs(pairs: Sequence[Tuple[str, str]],
                    n_shards: int) -> Tuple[Tuple[Tuple[str, str], ...], ...]:
    """Deterministic, balanced routing of (anchor, target) pairs to
    ``n_shards`` shards: round-robin over the *sorted* pair list, so the
    same pair set always yields the same partition — in every process (no
    salted ``hash()``), on every host. ``ModelBank.split`` and the shard
    plane (``repro_torch.serve.shard``) both consume this, which is what keeps
    the planner's routing and the workers' loaded sub-banks in agreement.
    Shard counts beyond the pair count leave trailing shards empty."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    ordered = sorted(pairs)
    return tuple(tuple(ordered[s::n_shards]) for s in range(n_shards))


def shard_of_pair(pair: Tuple[str, str], pairs: Sequence[Tuple[str, str]],
                  n_shards: int) -> int:
    """The shard :func:`partition_pairs` routes ``pair`` to within the
    full ``pairs`` set."""
    ordered = sorted(pairs)
    try:
        return ordered.index(tuple(pair)) % n_shards
    except ValueError:
        raise UnknownDeviceError(
            f"pair {pair!r} is not in the routed pair set") from None


def request_fingerprint(req: PredictRequest) -> tuple:
    """Hashable identity of a request's *content* — the serving cache key.
    Two requests with equal fields (including an equal-by-value client
    profile) map to the same fingerprint."""
    prof = (None if req.profile is None
            else tuple(sorted(req.profile.items())))
    return (req.anchor, req.target, req.workload.case, req.mode, req.knob,
            prof)


def _anchor_usable(anchor: str, req: PredictRequest, dataset,
                   trained_pairs: Set[Tuple[str, str]]) -> bool:
    """Can ``anchor`` answer ``req`` from the offline dataset alone?"""
    measured = dataset.measurements.get(anchor)
    if measured is None:
        return False
    case = req.workload.case
    if req.mode == MODE_MEASURED:
        # only the target itself can answer a measured request
        return anchor == req.target and case in measured
    if anchor == req.target:
        return case in measured
    if (anchor, req.target) not in trained_pairs:
        return False
    has_case = case in measured
    if req.mode == MODE_CROSS:
        return has_case
    if req.mode == MODE_TWO_PHASE:
        return minmax_cases(req.workload, req.knob, measured) is not None
    # auto: routes to cross on an exact-case profile, else two-phase
    return has_case or minmax_cases(req.workload, req.knob,
                                    measured) is not None


def choose_anchor(req: PredictRequest, dataset,
                  trained_pairs: Set[Tuple[str, str]]) -> str:
    """Cross-anchor admission policy: the cheapest anchor (catalog hourly
    price, name as tie-break) holding a profile that can answer ``req``.

    Client-supplied profiles are anchor-specific measurements, so an
    ``ANCHOR_ANY`` request carrying one is unroutable — the client must
    name the anchor it profiled on. Anchors without a catalog price are
    never chosen (their serving cost is unknowable)."""
    if req.profile is not None:
        raise UnsupportedRequestError(
            "anchor='any' cannot carry a client profile (profiles are "
            "anchor-specific) — name the anchor the profile was taken on")
    ranked = []
    for anchor in dataset.measurements:
        dev = device_catalog.CATALOG.get(anchor)
        if dev is None or not _anchor_usable(anchor, req, dataset,
                                             trained_pairs):
            continue
        ranked.append((dev.price_hr, anchor))
    if not ranked:
        raise UnsupportedRequestError(
            f"no anchor holds a usable profile for {req.workload.case} -> "
            f"{req.target!r} (mode {req.mode!r}); anchors considered: "
            f"{', '.join(sorted(dataset.measurements)) or 'none'}")
    return min(ranked)[1]


def plan_request(req: PredictRequest, dataset,
                 trained_pairs: Set[Tuple[str, str]]) -> PredictPlan:
    """Resolve one request to an executable plan (see module docstring for
    the validation order). ``dataset`` is a ``workloads.Dataset``;
    ``trained_pairs`` is the oracle's fitted (anchor, target) set.

    ``anchor == ANCHOR_ANY`` is rewritten first via :func:`choose_anchor`
    (cheapest anchor with a usable profile); the plan's ``request`` carries
    the concrete anchor so the executor and the result report where the
    prediction actually came from."""
    if req.anchor == ANCHOR_ANY:
        req = dataclasses.replace(
            req, anchor=choose_anchor(req, dataset, trained_pairs))
    case = req.workload.case
    if req.anchor not in dataset.measurements:
        raise UnknownDeviceError(
            f"unknown anchor {req.anchor!r}; available: "
            f"{', '.join(sorted(dataset.measurements))}")
    measured = dataset.measurements[req.anchor]

    if req.target == req.anchor:
        if case not in measured:
            raise UnsupportedRequestError(
                f"target == anchor {req.anchor!r} but case {case} was "
                "never measured on it")
        return PredictPlan(request=req, mode=MODE_MEASURED,
                           price_hr=resolve_price(req.target),
                           measured_ms=float(dataset.latency(req.anchor,
                                                             case)))

    if (req.anchor, req.target) not in trained_pairs:
        trained = sorted({a for a, _ in trained_pairs})
        raise UnknownDeviceError(
            f"no trained model for pair ({req.anchor!r} -> {req.target!r}); "
            f"trained anchors: {', '.join(trained) or 'none'}")

    mode = req.mode
    if mode == MODE_AUTO:
        has_profile = req.profile is not None or case in measured
        mode = MODE_CROSS if has_profile else MODE_TWO_PHASE

    if mode == MODE_CROSS:
        profile = req.profile
        if profile is None:
            if case not in measured:
                raise UnsupportedRequestError(
                    f"mode=cross needs a profile of {case} on "
                    f"{req.anchor!r} (not in the offline dataset and none "
                    "was supplied)")
            profile = dataset.profile(req.anchor, case)
        return PredictPlan(request=req, mode=MODE_CROSS,
                           price_hr=resolve_price(req.target),
                           profile=profile)

    if mode == MODE_TWO_PHASE:
        pair = minmax_cases(req.workload, req.knob, measured)
        if pair is None:
            raise UnsupportedRequestError(
                f"two-phase needs the {req.knob} min/max configs of "
                f"{req.workload.model} measured on {req.anchor!r}")
        lo, hi = pair
        return PredictPlan(request=req, mode=MODE_TWO_PHASE,
                           price_hr=resolve_price(req.target),
                           case_min=lo, case_max=hi,
                           profile_min=dataset.profile(req.anchor, lo),
                           profile_max=dataset.profile(req.anchor, hi))

    raise UnsupportedRequestError(f"unknown mode {req.mode!r}")


def plan_many(reqs: Sequence[PredictRequest], dataset,
              trained_pairs: Set[Tuple[str, str]]) -> list:
    return [plan_request(r, dataset, trained_pairs) for r in reqs]

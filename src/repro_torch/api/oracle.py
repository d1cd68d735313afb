"""``LatencyOracle`` — the single public prediction facade.

Wraps a fitted :class:`repro_torch.core.predictor.Profet` and the offline
:class:`repro_torch.core.workloads.Dataset` it was fit on. Prediction is a
three-stage plan -> batch -> execute pipeline:

  - **plan** (``repro_torch.api.planner``): each typed ``PredictRequest`` resolves
    to a pure ``PredictPlan`` — final mode (``measured`` / ``cross`` /
    ``two_phase``), anchor profile rows, oracle-chosen min/max configs, and
    the target's catalog price — with every routing error raised here, per
    request, before the model is touched.
  - **batch + execute** (``repro_torch.api.executor``): heterogeneous plans are
    grouped by (anchor, target) and the WHOLE batch is answered in one
    stacked dispatch through the oracle's :class:`repro_torch.api.bank.ModelBank`
    (one grouped forest launch + one stacked MLP apply, ``fused_calls ==
    1``); unbankable models fall back to one fused
    ``MedianEnsemble.predict`` per group. Two-phase plans ride their
    min/max rows in the same dispatch and interpolate vectorized
    afterwards.

``predict_many`` is the primary entry point; ``predict`` and
``predict_grid`` are thin wrappers over the same engine — there is no
separate per-request routing path left. ``repro_torch.serve.LatencyService``
adds wave microbatching + a prediction cache on top.

``fit`` is vectorized too: per anchor one shared feature matrix, one
level-synchronously grown packed forest per target, and ALL targets' DNN
heads trained as one stacked model. The model and its bank live on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.predictor import Profet, ProfetConfig
from repro_torch.api import planner as planner_mod
from repro_torch.api.executor import execute_plans
from repro_torch.api.types import (BatchPredictResult, MODE_MEASURED, GridRequest,
                             GridResult, PredictPlan, PredictRequest,
                             PredictResult, UnknownDeviceError, Workload)


@dataclasses.dataclass(frozen=True)
class GridScatter:
    """Where each staged grid cell lands in the dense (targets, batches,
    pixels) array: feasible cell ``c`` of every target scatters to
    ``[:, jj[c], kk[c]]``."""
    jj: np.ndarray
    kk: np.ndarray


def assemble_grid(req: GridRequest, scatter: GridScatter,
                  latencies: np.ndarray) -> GridResult:
    """Stage 2 of a grid sweep: scatter the flat ``latencies`` of the
    staged request batch (targets-major) back into the dense grid."""
    out = np.full((len(req.targets), len(req.batches), len(req.pixels)),
                  np.nan)
    n_cells = len(scatter.jj)
    if n_cells:
        lat = np.asarray(latencies, dtype=float).reshape(len(req.targets),
                                                         n_cells)
        for i in range(len(req.targets)):
            out[i, scatter.jj, scatter.kk] = lat[i]
    return GridResult(request=req, latency_ms=out)


@dataclasses.dataclass(frozen=True)
class AdviseScatter:
    """Row order of a staged advisor sweep: ``fixed`` rows (client-measured
    anchor latency) by position, plus where each staged request's result
    goes."""
    n: int
    fixed: Dict[int, PredictResult]
    req_pos: List[int]


def assemble_advise(scatter: AdviseScatter, results: Sequence[PredictResult],
                    epoch: Optional[str] = None) -> List[PredictResult]:
    """``epoch`` stamps the fixed (client-measured) rows so every row of an
    advisor sweep carries the epoch that answered it, like the staged
    results do."""
    rows = {pos: (dataclasses.replace(r, epoch=epoch) if epoch is not None
                  else r)
            for pos, r in scatter.fixed.items()}
    for pos, res in zip(scatter.req_pos, results):
        rows[pos] = res
    return [rows[pos] for pos in range(scatter.n)]


class LatencyOracle:
    """Query-style interface over a fitted PROFET model + its dataset."""

    def __init__(self, profet: Profet, dataset: workloads.Dataset):
        self.profet = profet
        self.dataset = dataset
        self._bank = None
        self._bank_built = False
        self._bank_error = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, dataset: Optional[workloads.Dataset] = None,
            config: Optional[ProfetConfig] = None,
            train_cases: Optional[Sequence] = None,
            anchors: Optional[Sequence[str]] = None,
            targets: Optional[Sequence[str]] = None,
            device="cuda") -> "LatencyOracle":
        """Fit a fresh oracle on ``device``; ``dataset=None`` generates the
        paper grid. Training runs the vectorized per-anchor path (shared
        feature matrix, packed forests, jointly trained DNN heads)."""
        ds = dataset if dataset is not None else workloads.generate()
        profet = Profet(config or ProfetConfig(), device=device).fit(
            ds, train_cases, anchors=anchors, targets=targets)
        return cls(profet, ds)

    def clone_with_pairs(self, overrides: Dict[Tuple[str, str], object]
                         ) -> "LatencyOracle":
        """A candidate oracle with ``overrides``' phase-1 ensembles swapped
        in over this oracle's pairs (live-calibration refits): the clone
        shares the dataset, the fitted feature clustering, and the phase-2
        knob scalers — overridden ensembles MUST have been fit on feature
        matrices from this oracle's :meth:`feature_matrix` — but owns its
        own ``cross`` table and ModelBank, so banking/warming/serving the
        candidate never mutates the incumbent. Every overridden pair must
        already be trained here."""
        for anchor, target in overrides:
            self._check_pair(anchor, target)
        profet = Profet(self.config, device=self.profet.device)
        profet.features = self.profet.features
        profet.batch_scalers = self.profet.batch_scalers
        profet.pixel_scalers = self.profet.pixel_scalers
        profet.cross = {**self.profet.cross, **dict(overrides)}
        return LatencyOracle(profet, self.dataset)

    # ------------------------------------------------------------------
    # introspection (kept public so benchmarks never reach into Profet)
    # ------------------------------------------------------------------
    @property
    def config(self) -> ProfetConfig:
        return self.profet.cfg

    @property
    def fingerprint(self) -> str:
        """The artifact-store config fingerprint of this oracle — the
        default cache *epoch* a serving layer keys its entries to."""
        from repro_torch.api.artifacts import config_fingerprint
        return config_fingerprint(self.config)

    @property
    def features(self):
        return self.profet.features

    def pairs(self) -> List[Tuple[str, str]]:
        """Trained (anchor, target) pairs."""
        return sorted(self.profet.cross)

    def targets_from(self, anchor: str) -> Tuple[str, ...]:
        return tuple(t for (a, t) in self.pairs() if a == anchor)

    def ensemble(self, anchor: str, target: str):
        """The phase-1 ensemble of one pair (member-level benchmarks)."""
        self._check_pair(anchor, target)
        return self.profet.cross[(anchor, target)]

    # ------------------------------------------------------------------
    # stacked execution (ModelBank)
    # ------------------------------------------------------------------
    @property
    def bank(self):
        """This oracle's :class:`repro_torch.api.bank.ModelBank` — every
        fitted pair packed into stacked tensors so a wave is ONE grouped
        forest launch + one stacked MLP apply. Built on first use (or
        eagerly via :meth:`warmup`) and owned by the oracle, so a serving
        layer's ``oracle_refreshed`` swap replaces model and bank
        atomically. ``None`` when the fitted members cannot be stacked —
        execution then falls back per group. A bank *build* that dies
        unexpectedly also resolves to ``None`` (the slower per-group path
        keeps answering) with the failure recorded in :attr:`bank_error`
        so a serving layer can flag itself degraded instead of going
        down."""
        if not self._bank_built:
            from repro_torch.api.bank import BankUnsupportedError, ModelBank
            try:
                self._bank = ModelBank.build(self.profet)
            except BankUnsupportedError:
                self._bank = None
            except Exception as e:
                self._bank = None
                self._bank_error = f"{type(e).__name__}: {e}"
            self._bank_built = True
        return self._bank

    @property
    def bank_error(self) -> Optional[str]:
        """Why the last bank build *failed* (not merely "unbankable"), or
        ``None`` when the bank is healthy or legitimately absent."""
        return self._bank_error

    def warmup(self, max_rows: int = 64) -> float:
        """Epoch-aware warm-up: build the bank, load the kernel library and
        run the MLP bucket shapes up to ``max_rows`` so the first wave
        served after a deploy/refresh pays no one-off cost. Returns wall
        seconds spent (0.0 when the model is unbankable)."""
        bank = self.bank
        return bank.warmup(max_rows=max_rows) if bank is not None else 0.0

    def feature_matrix(self, anchor: str, cases: Sequence) -> np.ndarray:
        """Phase-1 feature matrix of dataset profiles taken on ``anchor``."""
        return self.profet.feature_matrix(
            [self.dataset.profile(anchor, c) for c in cases], cases)

    # ------------------------------------------------------------------
    # plan -> batch -> execute
    # ------------------------------------------------------------------
    def plan(self, req: PredictRequest) -> PredictPlan:
        """Stage 1 only: resolve one request to a pure execution plan.
        All routing/validation errors (unknown device, unroutable request,
        missing catalog price) are raised here."""
        return planner_mod.plan_request(req, self.dataset,
                                        set(self.profet.cross))

    def execute(self, plans: Sequence[PredictPlan],
                epoch: Optional[str] = None,
                banked: bool = True, bank=None) -> BatchPredictResult:
        """Stages 2+3: answer already-planned requests in ONE stacked
        dispatch through the oracle's :attr:`bank` (grouped forest launch +
        stacked MLP apply for the whole batch, ``fused_calls == 1``);
        unbankable models fall back to one fused ensemble call per
        (anchor, target) pair. Results are stamped with ``epoch`` (a
        serving layer's cache epoch); when omitted the oracle's own config
        fingerprint is used. ``banked=False`` forces the per-group path —
        a serving layer's degraded mode after a warm-up/bank failure.
        ``bank`` overrides the oracle's own bank with an externally
        managed one."""
        if bank is None:
            bank = self.bank if banked else None
        return execute_plans(self.profet, plans,
                             epoch=self.fingerprint if epoch is None
                             else epoch,
                             bank=bank)

    def predict_many(self,
                     reqs: Sequence[PredictRequest]) -> BatchPredictResult:
        """Plan and execute a heterogeneous request batch. Results are in
        request order and element-wise identical to per-request
        ``predict``."""
        return self.execute([self.plan(r) for r in reqs])

    def predict(self, req: PredictRequest) -> PredictResult:
        """One request — a single-element ``predict_many``."""
        return self.predict_many([req]).results[0]

    def predict_cases(self, anchor: str, target: str,
                      cases: Sequence) -> np.ndarray:
        """Vectorized phase-1 over an explicit case list (one ensemble call);
        profiles come from the oracle's dataset."""
        self._check_pair(anchor, target)
        return self.profet.predict_cross_matrix(
            anchor, target, self.feature_matrix(anchor, cases))

    def interpolate(self, target: str, knob: str, value,
                    t_min: float, t_max: float) -> float:
        """Phase 2 alone: knob interpolation from TRUE min/max latencies
        (the paper's Fig-11a "True" mode)."""
        return float(self.profet.predict_knob(target, knob, value,
                                              t_min, t_max))

    def stage_grid(self, req: GridRequest
                   ) -> Tuple[List[PredictRequest], "GridScatter"]:
        """Stage 1 of a grid sweep: validate the request and expand its
        feasible cells into the per-cell ``PredictRequest`` batch (shared
        rows dedup in the executor). A transport admits the batch through
        its service and reassembles with :func:`assemble_grid`;
        :meth:`predict_grid` is the in-process composition of the two."""
        if req.anchor not in self.dataset.measurements:
            raise UnknownDeviceError(
                f"anchor {req.anchor!r} not in the oracle's dataset; "
                f"available: {', '.join(sorted(self.dataset.measurements))}")
        for target in req.targets:
            if target != req.anchor:
                self._check_pair(req.anchor, target)
        measured = self.dataset.measurements[req.anchor]
        cells = [(j, k, (req.model, b, p))
                 for j, b in enumerate(req.batches)
                 for k, p in enumerate(req.pixels)
                 if (req.model, b, p) in measured]
        cases = [c for _, _, c in cells]
        reqs = [PredictRequest(req.anchor, t, Workload.from_case(c))
                for t in req.targets for c in cases]
        scatter = GridScatter(
            jj=np.array([j for j, _, _ in cells], dtype=int),
            kk=np.array([k for _, k, _ in cells], dtype=int))
        return reqs, scatter

    def predict_grid(self, req: GridRequest) -> GridResult:
        """Vectorized sweep: the feasible cells of every target become one
        ``predict_many`` batch — one shared anchor feature matrix (rows
        dedup across targets) and one fused ensemble call per target."""
        reqs, scatter = self.stage_grid(req)
        lat = self.predict_many(reqs).latencies() if reqs else np.empty(0)
        return assemble_grid(req, scatter, lat)

    # ------------------------------------------------------------------
    # advisor
    # ------------------------------------------------------------------
    def stage_advise(self, anchor: str, workload: Workload,
                     profile: Optional[Dict[str, float]] = None,
                     measured_ms: Optional[float] = None,
                     targets: Optional[Sequence[str]] = None
                     ) -> Tuple[List[PredictRequest], "AdviseScatter"]:
        """Stage 1 of an advisor sweep: the per-target ``PredictRequest``
        batch plus the fixed rows (the anchor's own row when the client
        supplies ``measured_ms``) and their positions. Reassemble with
        :func:`assemble_advise`."""
        order = list(targets or (anchor,) + self.targets_from(anchor))
        fixed: Dict[int, PredictResult] = {}
        reqs: List[PredictRequest] = []
        req_pos: List[int] = []
        for pos, target in enumerate(order):
            if target == anchor and measured_ms is not None:
                fixed[pos] = PredictResult(
                    latency_ms=float(measured_ms), anchor=anchor,
                    target=target, workload=workload, mode=MODE_MEASURED,
                    price_hr=planner_mod.resolve_price(target))
                continue
            reqs.append(PredictRequest(anchor, target, workload,
                                       profile=profile))
            req_pos.append(pos)
        return reqs, AdviseScatter(n=len(order), fixed=fixed,
                                   req_pos=req_pos)

    def advise(self, anchor: str, workload: Workload,
               profile: Optional[Dict[str, float]] = None,
               measured_ms: Optional[float] = None,
               targets: Optional[Sequence[str]] = None) -> List[PredictResult]:
        """Latency on every reachable target from one anchor profile (the
        paper's Fig-3 scenario); price the rows via ``.cost_usd(steps)``.
        The whole candidate sweep is answered by ONE ``predict_many``
        batch. The anchor's own row uses ``measured_ms`` when the client
        supplies it."""
        reqs, scatter = self.stage_advise(anchor, workload, profile,
                                          measured_ms, targets)
        return assemble_advise(scatter, self.predict_many(reqs).results,
                               epoch=self.fingerprint)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def minmax_cases(self, workload: Workload, knob: str,
                     anchor: str) -> Optional[Tuple[tuple, tuple]]:
        """The (lo, hi) anchor configs two-phase interpolation rests on:
        the workload with its ``knob`` swung to the grid min/max. None if
        either config was never measured on the anchor."""
        return planner_mod.minmax_cases(
            workload, knob, self.dataset.measurements.get(anchor, {}))

    def _check_pair(self, anchor: str, target: str) -> None:
        if (anchor, target) not in self.profet.cross:
            trained = sorted({a for a, _ in self.profet.cross})
            raise UnknownDeviceError(
                f"no trained model for pair ({anchor!r} -> {target!r}); "
                f"trained anchors: {', '.join(trained) or 'none'}")

"""PROFET end-to-end predictor (paper §III-C).

Two separate models (the paper's Table-II "Separate Modeling" design):
  Phase 1  cross-instance: per (anchor g_a, target g_t) a median ensemble
           trained on D_{g_a->g_t} = {(x profiled on g_a, y measured on g_t)}.
  Phase 2  batch/pixel scaling: per instance, min-max + order-2 polynomial
           (scaling.PolyScaler), denormalized with true or predicted min/max.

The port keeps the reference's structure; the forest and DNN members live
on ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import workloads
from repro_torch.core.clustering import FeatureClustering, identity_features
from repro_torch.core.ensemble import MedianEnsemble
from repro_torch.core.scaling import PolyScaler


@dataclasses.dataclass
class ProfetConfig:
    clustering: bool = True
    max_height: float = 2.0  # empirically-best cut for OUR op vocabulary
                             # (the paper's 6.0 is tuned to its 65 TF names)
    poly_order: int = 2
    dnn_epochs: int = 300
    n_trees: int = 60
    seed: int = 0
    members: Tuple[str, ...] = ("linear", "forest", "dnn")
    # Paper-faithful X = profiled op features only. Appending the (batch, pix)
    # knob scalars is a beyond-paper variant (knobs are user-chosen configs,
    # not architecture secrets) evaluated separately in benchmarks.
    extra_knob_features: bool = False


class Profet:
    """Fit on a workloads.Dataset; predict latency on any catalog device /
    batch / pixel config from a single anchor-device profile."""

    def __init__(self, config: ProfetConfig = ProfetConfig(),
                 device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.features: Optional[FeatureClustering] = None
        self.cross: Dict[Tuple[str, str], MedianEnsemble] = {}
        self.batch_scalers: Dict[str, PolyScaler] = {}
        self.pixel_scalers: Dict[str, PolyScaler] = {}

    # ------------------------------------------------------------------
    def _vec(self, profile: Dict[str, float], case=None) -> np.ndarray:
        x = self.features.transform(profile)
        if self.cfg.extra_knob_features and case is not None:
            _, b, p = case
            x = np.concatenate([x, [float(b), float(p)]])
        return x

    def _matrix(self, ds, device, cases) -> np.ndarray:
        return self.feature_matrix([ds.profile(device, c) for c in cases],
                                   cases)

    def feature_matrix(self, profiles: Sequence[Dict[str, float]],
                       cases: Optional[Sequence] = None) -> np.ndarray:
        """Stack anchor profiles into one (N, D) phase-1 feature matrix —
        the vectorized entry point used by ``repro.api.predict_grid``."""
        X = self.features.transform_many(profiles)
        if self.cfg.extra_knob_features:
            if cases is None:
                raise ValueError("extra_knob_features=True requires cases")
            knobs = np.array([[float(b), float(p)] for (_, b, p) in cases])
            X = np.concatenate([X, knobs], axis=1)
        return X

    # ------------------------------------------------------------------
    def fit(self, ds: workloads.Dataset,
            train_cases: Optional[Sequence] = None,
            anchors: Optional[Sequence[str]] = None,
            targets: Optional[Sequence[str]] = None) -> "Profet":
        """``anchors``/``targets`` restrict which cross-device pairs are
        trained (default: all ordered pairs of ds.devices) — e.g. Table VI
        trains old-anchor -> new-target pairs only.

        Phase 1 is trained per ANCHOR, not per pair: the anchor's profile
        matrix is built once and shared by every target, and all targets'
        DNN heads train jointly as one stacked model on ``device``
        (``regressors.fit_dnn_multi``); each target still gets its own
        linear model and level-synchronously grown forest.
        """
        anchors = list(anchors or ds.devices)
        targets = list(targets or ds.devices)
        cases = list(train_cases or ds.cases)
        profiles = self._fit_features(ds, anchors, cases)

        # phase 1: one anchor feature matrix + one joint DNN fit per anchor
        lat = {gt: np.array([ds.latency(gt, c) for c in cases])
               for gt in targets}
        for ga in anchors:
            X = self.feature_matrix(profiles[ga], cases)
            tgts = [gt for gt in targets if gt != ga]
            if not tgts:
                continue
            dnn_heads = {}
            if "dnn" in self.cfg.members:
                from repro_torch.core.regressors import fit_dnn_multi
                heads = fit_dnn_multi(X, np.stack([lat[gt] for gt in tgts]),
                                      epochs=self.cfg.dnn_epochs,
                                      seed=self.cfg.seed,
                                      device=self.device)
                dnn_heads = dict(zip(tgts, heads))
            for gt in tgts:
                ens = MedianEnsemble(seed=self.cfg.seed,
                                     dnn_epochs=self.cfg.dnn_epochs,
                                     n_trees=self.cfg.n_trees,
                                     members=self.cfg.members,
                                     device=self.device)
                prefit = {"dnn": dnn_heads[gt]} if dnn_heads else None
                self.cross[(ga, gt)] = ens.fit(X, lat[gt], prefit=prefit)

        self._fit_phase2(ds, anchors, targets, cases)
        return self

    def _fit_features(self, ds: workloads.Dataset, anchors: Sequence[str],
                      cases: Sequence) -> Dict[str, List[Dict[str, float]]]:
        """Fit the op-name feature space; returns each anchor's profiles
        (fetched ONCE and reused for both the name vocabulary and the
        per-anchor feature matrices)."""
        profiles = {d: [ds.profile(d, c) for c in cases] for d in anchors}
        names = sorted({op for d in anchors for prof in profiles[d]
                        for op in prof})
        self.features = (FeatureClustering.fit(names, self.cfg.max_height)
                         if self.cfg.clustering else identity_features(names))
        return profiles

    def _fit_phase2(self, ds: workloads.Dataset, anchors: Sequence[str],
                    targets: Sequence[str], cases: Sequence) -> None:
        """Phase 2: per-device scalers over batch and pixel knobs."""
        for dev in sorted(set(anchors) | set(targets)):
            kb, kp, lat = [], [], []
            g_b, g_p = [], []
            for (m, b, p) in cases:
                lt = ds.latency(dev, (m, b, p))
                kb.append(b)
                kp.append(p)
                lat.append(lt)
                g_b.append(f"{m}|{p}")
                g_p.append(f"{m}|{b}")
            kb, kp, lat = map(np.asarray, (kb, kp, lat))
            self.batch_scalers[dev] = PolyScaler(
                order=self.cfg.poly_order, min_knob=min(workloads.BATCHES),
                max_knob=max(workloads.BATCHES)).fit(kb, lat, np.asarray(g_b))
            self.pixel_scalers[dev] = PolyScaler(
                order=self.cfg.poly_order, min_knob=min(workloads.PIXELS),
                max_knob=max(workloads.PIXELS)).fit(kp, lat, np.asarray(g_p))

    # ------------------------------------------------------------------
    def predict_cross(self, anchor: str, target: str,
                      profile: Dict[str, float], case=None) -> float:
        """Phase 1: latency on ``target`` from a profile taken on ``anchor``."""
        x = self._vec(profile, case)[None, :]
        return float(self.cross[(anchor, target)].predict(x)[0])

    def predict_cross_many(self, anchor: str, target: str, ds, cases):
        X = self._matrix(ds, anchor, cases)
        return self.predict_cross_matrix(anchor, target, X)

    def predict_cross_matrix(self, anchor: str, target: str,
                             X: np.ndarray) -> np.ndarray:
        """Phase 1 on a prebuilt feature matrix: ONE ensemble call for all
        rows (the per-(anchor, target) hot path of the grid predictor)."""
        return self.cross[(anchor, target)].predict(np.asarray(X))

    def scaler_stack(self, devices: Sequence[str]) -> Dict[str, tuple]:
        """Stacked phase-2 coefficient matrices for ``repro_torch.api.bank``:
        per knob kind, the ``(n_devices, order+1)`` polyfit coefficients
        plus the ``(n_devices,)`` knob-range vectors, row ``i`` belonging
        to ``devices[i]``. Evaluating them row-wise with Horner's rule is
        bit-identical to each device's ``PolyScaler.predict``."""
        out = {}
        for kind, scalers in (("batch", self.batch_scalers),
                              ("pixel", self.pixel_scalers)):
            coef = np.stack([np.asarray(scalers[d].coef, np.float64)
                             for d in devices])
            lo = np.array([scalers[d].min_knob for d in devices])
            hi = np.array([scalers[d].max_knob for d in devices])
            out[kind] = (coef, lo, hi)
        return out

    def predict_knob(self, device: str, kind: str, value,
                     t_min: float, t_max: float) -> np.ndarray:
        """Phase 2: latency at batch/pixel ``value`` given min/max-config
        latencies (true measurements or phase-1 predictions)."""
        scaler = (self.batch_scalers if kind == "batch"
                  else self.pixel_scalers)[device]
        return scaler.predict(value, t_min, t_max)

    def predict_two_phase(self, anchor: str, target: str, kind: str, value,
                          profile_min: Dict[str, float],
                          profile_max: Dict[str, float],
                          case_min=None, case_max=None) -> float:
        """Full pipeline ("Predict" mode of Fig 11): phase-1 predicts the
        min/max-config latencies on the target; phase-2 interpolates."""
        t_min = self.predict_cross(anchor, target, profile_min, case_min)
        t_max = self.predict_cross(anchor, target, profile_max, case_max)
        return float(self.predict_knob(target, kind, value, t_min, t_max))

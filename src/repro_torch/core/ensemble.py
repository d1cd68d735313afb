"""Median-bagging ensemble (paper §III-C1): three independently trained
models — linear, random forest, DNN — combined by taking the MEDIAN of their
predictions per sample (Lang et al.'s median ensembling, which the paper
adopts to suppress single-model outliers).

The median stays ``np.median`` on the host: with two members it averages
the middle pair, where ``torch.median`` would return the lower one."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.regressors import (DNNRegressor, LinearRegressor,
                                         RandomForestRegressor)


class MedianEnsemble:
    def __init__(self, seed: int = 0, dnn_epochs: int = 400,
                 n_trees: int = 100, members: Optional[Sequence[str]] = None,
                 device="cuda"):
        self.members = tuple(members or ("linear", "forest", "dnn"))
        self.models = {}
        self.seed = seed
        self.dnn_epochs = dnn_epochs
        self.n_trees = n_trees
        self.device = resolve_device(device)

    def _make(self, name: str):
        if name == "linear":
            return LinearRegressor()
        if name == "forest":
            return RandomForestRegressor(n_estimators=self.n_trees,
                                         seed=self.seed, device=self.device)
        if name == "dnn":
            return DNNRegressor(epochs=self.dnn_epochs, seed=self.seed,
                                device=self.device)
        raise KeyError(name)

    def fit(self, X: np.ndarray, y: np.ndarray,
            prefit: Optional[Dict[str, object]] = None) -> "MedianEnsemble":
        """``prefit`` injects already-trained members (keyed by member name):
        the joint per-anchor path in ``Profet.fit`` trains all targets' DNN
        heads in one stacked call and hands each ensemble its slice here."""
        prefit = prefit or {}
        self.models = {m: prefit[m] if m in prefit else self._make(m).fit(X, y)
                       for m in self.members}
        return self

    def predict_members(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        return {m: self.models[m].predict(X) for m in self.members}

    def predict(self, X: np.ndarray) -> np.ndarray:
        preds = np.stack(list(self.predict_members(X).values()))
        return np.median(preds, axis=0)

    def member_selection_counts(self, X: np.ndarray) -> Dict[str, int]:
        """How often each member IS the median (paper reports 25.8/32.8/41.4%)."""
        member_preds = self.predict_members(X)
        names = list(member_preds)
        preds = np.stack([member_preds[m] for m in names])
        med = np.median(preds, axis=0)
        counts = {m: 0 for m in names}
        for j in range(preds.shape[1]):
            diffs = np.abs(preds[:, j] - med[j])
            counts[names[int(np.argmin(diffs))]] += 1
        return counts


def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(y_pred - y_true) /
                         np.maximum(np.abs(y_true), 1e-12)) * 100.0)


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(y_pred) - np.asarray(y_true)) ** 2)))


def r2(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-12))

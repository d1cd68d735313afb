"""Workload grid (paper §III): G x M x B x P Cartesian product with
infeasible cells filtered, mirroring the paper's 1228-case dataset."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cnn_zoo, simulator
from repro_torch.core.devices import CATALOG, PAPER_DEVICES

BATCHES = (16, 32, 64, 128, 256)
PIXELS = (32, 64, 128, 224, 256)


@dataclasses.dataclass
class Dataset:
    """measurements[device][(model, batch, pix)] -> Measurement"""
    devices: Tuple[str, ...]
    cases: List[Tuple[str, int, int]]               # (model, batch, pix)
    measurements: Dict[str, Dict[Tuple[str, int, int], simulator.Measurement]]

    def profile(self, device, case):
        return self.measurements[device][case].profile

    def latency(self, device, case):
        return self.measurements[device][case].latency_ms

    def subset(self, devices) -> "Dataset":
        """View with a restricted device set (same cases)."""
        devices = tuple(devices)
        missing = [d for d in devices if d not in self.measurements]
        if missing:
            raise KeyError(
                f"device(s) {', '.join(map(repr, missing))} not in dataset; "
                f"available: {', '.join(sorted(self.measurements))}")
        return Dataset(devices=devices, cases=self.cases,
                       measurements={d: self.measurements[d] for d in devices})


def generate(devices: Sequence[str] = PAPER_DEVICES,
             models: Sequence[str] = cnn_zoo.MODEL_NAMES,
             batches: Sequence[int] = BATCHES,
             pixels: Sequence[int] = PIXELS,
             seed: int = 0) -> Dataset:
    """Feasibility: a case is kept only if it runs on EVERY device in the
    grid (the paper pairs anchor features with target latencies, so both
    sides must exist)."""
    cases = []
    for m in models:
        for b in batches:
            for p in pixels:
                if all(simulator.feasible(CATALOG[d], m, b, p) for d in devices):
                    cases.append((m, b, p))
    meas = {d: {} for d in devices}
    for d in devices:
        for (m, b, p) in cases:
            meas[d][(m, b, p)] = simulator.measure(d, m, b, p, seed=seed)
    return Dataset(devices=tuple(devices), cases=cases, measurements=meas)


def split_cases(cases: Sequence[Tuple[str, int, int]], *, test_frac: float = 0.2,
                seed: int = 0, by_model: bool = False):
    """Train/test split. ``by_model=True`` holds out whole model families
    (harder: unseen op mixes), else a random case split."""
    rng = np.random.default_rng(seed)
    if by_model:
        models = sorted({c[0] for c in cases})
        n_test = max(1, int(len(models) * test_frac))
        test_models = set(rng.choice(models, size=n_test, replace=False))
        train = [c for c in cases if c[0] not in test_models]
        test = [c for c in cases if c[0] in test_models]
    else:
        idx = rng.permutation(len(cases))
        n_test = int(len(cases) * test_frac)
        test_i = set(idx[:n_test].tolist())
        train = [c for i, c in enumerate(cases) if i not in test_i]
        test = [c for i, c in enumerate(cases) if i in test_i]
    return train, test

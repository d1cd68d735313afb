"""White-box baseline predictors the paper compares against (Tables III-V),
the port of ``repro.core.baselines``.

All three are re-implemented here because the paper's opponents cannot be run
in this environment (no GPUs, no TF1):

  - :class:`PaleoModel`      (Table III) — analytic FLOPs/bandwidth latency
    model with per-device "percent of peak" calibration, fed by the WHITE-BOX
    op graph (layer architecture), not by profiles.
  - :class:`MLPredictModel`  (Table IV) — per-workload feature MLP using the
    internal model architecture + hardware specs as features (Justus et al.).
  - :class:`HabitatScaling`  (Table V)  — per-op roofline "wave scaling" from
    an anchor-device profile to a target device (Yu et al.), needs hardware
    specs for both ends.

Their shared weakness, which PROFET's evaluation exploits: none of them sees
the measured *behavior* of the target platform stack (launch overheads,
occupancy saturation, profiler-calibrated efficiency), so they drift whenever
the analytic model diverges from the measurement plane.

Two meanings of "device" meet here. The ``device`` (and ``anchor`` /
``target``) arguments of ``calibrate``, ``predict`` and ``fit`` are catalog
device names (``"T4"``, ``"V100"``, ...): the hardware a workload's latency
is predicted for. Only ``MLPredictModel``'s constructor takes a torch
device, ``device="cuda"`` by default, where its MLP trains and predicts.
Paleo and Habitat are numpy on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cnn_zoo, simulator
from repro_torch.core.devices import CATALOG, Device
from repro_torch.core.regressors import DNNRegressor


# ---------------------------------------------------------------------------
# Paleo (Qi et al., ICLR'17)
# ---------------------------------------------------------------------------


class PaleoModel:
    """Analytic: t = sum_op max(flops / (PPP * peak), bytes / bw).

    PPP ("platform percent of peak") is calibrated per device from ONE
    measured workload — exactly Paleo's calibration protocol. Everything else
    is first-principles from the white-box op graph; no occupancy curve, no
    per-op launch overhead, which is where it loses accuracy on small ops.
    """

    def __init__(self):
        self.ppp: Dict[str, float] = {}

    def calibrate(self, device: str, case: Tuple[str, int, int],
                  measured_ms: float) -> "PaleoModel":
        return self.calibrate_many(device, [case], [measured_ms])

    def calibrate_many(self, device: str, cases: Sequence,
                       measured_ms: Sequence[float]) -> "PaleoModel":
        """Geometric-mean PPP over a calibration set (Paleo benchmarks several
        kernels to estimate percent-of-peak; one tiny workload would alias
        launch overhead into PPP and skew every large prediction)."""
        ratios = [self._raw_ms(device, c, ppp=1.0) / max(m, 1e-9)
                  for c, m in zip(cases, measured_ms)]
        self.ppp[device] = float(np.exp(np.mean(np.log(np.maximum(ratios,
                                                                  1e-6)))))
        return self

    def _raw_ms(self, device: str, case, ppp: float) -> float:
        dev = CATALOG[device]
        model, batch, pix = case
        total_us = 0.0
        for op in cnn_zoo.build_ops(model, batch, pix):
            t_comp = op.flops / (dev.peak_tflops * 1e6 * ppp)
            t_mem = op.bytes / (dev.mem_bw_gbs * 1e3)
            total_us += max(t_comp, t_mem)
        return total_us / 1e3

    def predict(self, device: str, case) -> float:
        ppp = self.ppp.get(device, 1.0)
        return self._raw_ms(device, case, ppp=1.0) / ppp if ppp else 0.0


# ---------------------------------------------------------------------------
# MLPredict (Justus et al., BigData'18)
# ---------------------------------------------------------------------------


def _arch_features(case) -> np.ndarray:
    """White-box per-workload features: totals + per-class breakdown of the
    op graph (the internal architecture the paper refuses to expose)."""
    model, batch, pix = case
    ops = cnn_zoo.build_ops(model, batch, pix)
    classes = ("conv", "dwconv", "matmul", "pool", "norm", "eltwise", "io",
               "misc")
    f_by, b_by, n_by = ({c: 0.0 for c in classes} for _ in range(3))
    for op in ops:
        c = simulator._op_class(op.name)
        f_by[c] += op.flops
        b_by[c] += op.bytes
        n_by[c] += 1.0
    feats = [float(batch), float(pix), float(batch * pix * pix),
             sum(f_by.values()), sum(b_by.values()), float(len(ops))]
    for c in classes:
        feats += [f_by[c], b_by[c], n_by[c]]
    return np.log1p(np.asarray(feats, np.float64))


def _device_features(dev: Device) -> np.ndarray:
    return np.asarray([dev.peak_tflops, dev.mem_bw_gbs, dev.mem_gb,
                       dev.launch_us, dev.pcie_gbs], np.float64)


class MLPredictModel:
    """One MLP over (architecture features ++ hardware features) -> latency.

    Faithful to the original's design point: trained jointly across devices
    with hardware specs as inputs. The paper (§V-D) found it optimized for
    small batches; the error growth at large batch emerges naturally here
    because the feature space is dominated by small-work cases.

    ``device`` is the torch device the MLP trains and predicts on (the card
    unless the caller asks for ``"cpu"``); the ``device`` argument of
    :meth:`predict` and the ``devices`` of :meth:`fit` are catalog names.
    """

    def __init__(self, epochs: int = 300, seed: int = 0, device="cuda"):
        self.reg = DNNRegressor(epochs=epochs, seed=seed, device=device)

    def _x(self, device: str, case) -> np.ndarray:
        return np.concatenate([_arch_features(case),
                               _device_features(CATALOG[device])])

    def fit(self, ds, cases: Sequence, devices: Optional[Sequence[str]] = None
            ) -> "MLPredictModel":
        devices = devices or ds.devices
        X = np.stack([self._x(d, c) for d in devices for c in cases])
        y = np.array([ds.latency(d, c) for d in devices for c in cases])
        self.reg.fit(X, y)
        return self

    def predict(self, device: str, case) -> float:
        return float(self.reg.predict(self._x(device, case)[None, :])[0])


# ---------------------------------------------------------------------------
# Habitat (Yu et al., ATC'21)
# ---------------------------------------------------------------------------


class HabitatScaling:
    """Per-op wave scaling: each profiled op latency is scaled from anchor to
    target by the compute-peak ratio if the op is compute-bound on the anchor
    or the bandwidth ratio if memory-bound. Uses DETAILED profiling output
    (per-op latency + the op's flops/bytes — i.e. more than PROFET's
    aggregated rows) plus both devices' specs.
    """

    def predict(self, anchor: str, target: str, case) -> float:
        da, dt = CATALOG[anchor], CATALOG[target]
        model, batch, pix = case
        total_us = 0.0
        for op in cnn_zoo.build_ops(model, batch, pix):
            t_anchor = simulator.op_latency_us(da, op)
            t_comp = op.flops / (da.peak_tflops * 1e6)
            t_mem = op.bytes / (da.mem_bw_gbs * 1e3)
            if t_comp >= t_mem:      # compute-bound on anchor
                # wave scaling: effective throughput ratio at this op's
                # occupancy level (Habitat models waves/occupancy explicitly)
                occ_a = op.flops / (op.flops + da.sat_gflop * 1e9)
                occ_t = op.flops / (op.flops + dt.sat_gflop * 1e9)
                ratio = (da.peak_tflops * occ_a) / (dt.peak_tflops * occ_t)
            else:                    # memory-bound on anchor
                ratio = da.mem_bw_gbs / dt.mem_bw_gbs
            # Habitat separates fixed kernel-dispatch latency from the
            # scalable wave portion: overhead belongs to the TARGET device.
            work = max(t_anchor - da.launch_us, 0.0)
            total_us += dt.launch_us + work * ratio
        return total_us / 1e3

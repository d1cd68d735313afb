"""Measurement-plane simulator: per-op latency model for the device catalog.

This container has no GPUs (the paper's measurement plane was AWS EC2), so
the 1228-workload dataset is regenerated with a calibrated analytic device
model. The model is intentionally NON-LINEAR in batch/pixel size — per-op
latency is

    t(op) = launch_us + max(flops / (peak * occupancy(op)), bytes / mem_bw)
    occupancy(work) = work / (work + sat)     (saturation curve)

so small ops pay a device-dependent floor (sat/peak) regardless of size.
This reproduces the paper's Fig-2c phenomenon: on V100 (large ``sat``) a 16x
batch increase can cost only ~1.5x latency for small models, while saturated
workloads (VGG13@128px on T4) scale ~13x. Profiling-enabled runs (the X
features) are 20-30% slower than the clean runs (the Y targets), as §III-A
measured.

Determinism: all noise is seeded from (device, model, batch, pix), so X and Y
are reproducible across calls.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cnn_zoo
from repro_torch.core.devices import CATALOG, Device

# per-op-kind device efficiency quirks: (compute_eff, mem_eff) multipliers.
# Older GPUs are relatively worse at depthwise/pointwise ops; everything is
# relative to the device's dense-conv efficiency.
_OP_CLASS_EFF = {
    "conv": (1.00, 1.00),
    "dwconv": (0.35, 0.90),
    "matmul": (0.90, 1.00),
    "pool": (0.60, 0.95),
    "norm": (0.50, 0.90),
    "eltwise": (0.50, 1.00),
    "io": (1.00, 1.00),
    "misc": (0.40, 0.80),
}

_CLASS_OF = {
    "Conv2D": "conv", "Conv2DBackpropInput": "conv",
    "Conv2DBackpropFilter": "conv",
    "DepthwiseConv2dNative": "dwconv",
    "DepthwiseConv2dNativeBackpropInput": "dwconv",
    "DepthwiseConv2dNativeBackpropFilter": "dwconv",
    "MatMul": "matmul",
    "MaxPool": "pool", "MaxPoolGrad": "pool",
    "AvgPool": "pool", "AvgPoolGrad": "pool",
    "FusedBatchNormV3": "norm", "FusedBatchNormGradV3": "norm",
    "LRN": "norm", "LRNGrad": "norm",
    "IteratorGetNext": "io",
}


def _op_class(name: str) -> str:
    if name in _CLASS_OF:
        return _CLASS_OF[name]
    if name.endswith("Grad") or name in ("Relu", "Relu6", "Tanh", "AddV2",
                                         "Mul", "Cast", "Softmax"):
        return "eltwise"
    return "misc"


def _rng_for(*key) -> np.random.Generator:
    h = hashlib.sha256("|".join(str(k) for k in key).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def _dwconv_flops_adjust(dev: Device) -> float:
    """Pre-Ampere GPUs do depthwise poorly; A10/TPUs are better."""
    return {"A10": 0.7, "TPUv4": 0.55, "TPUv5e": 0.55, "TPUv5p": 0.55}.get(
        dev.name, 1.0)


def op_latency_us(dev: Device, op: cnn_zoo.Op) -> float:
    """Deterministic (noise-free) per-op latency in microseconds."""
    ceff, meff = _OP_CLASS_EFF[_op_class(op.name)]
    if _op_class(op.name) == "dwconv":
        ceff *= _dwconv_flops_adjust(dev)
    if op.name == "IteratorGetNext":
        return dev.launch_us + op.bytes / (dev.pcie_gbs * 1e3)  # bytes/GBps->us
    work = op.flops
    occ = work / (work + dev.sat_gflop * 1e9)
    t_compute = work / (dev.peak_tflops * 1e6 * ceff * max(occ, 1e-9))
    t_mem = op.bytes / (dev.mem_bw_gbs * 1e3 * meff)
    return dev.launch_us + max(t_compute, t_mem)


@dataclasses.dataclass
class Measurement:
    model: str
    device: str
    batch: int
    pix: int
    profile: Dict[str, float]      # op name -> aggregated ms (profiling ON)
    latency_ms: float              # clean batch latency (profiling OFF)


def feasible(dev: Device, model: str, batch: int, pix: int) -> bool:
    mem = cnn_zoo.peak_activation_bytes(model, batch, pix)
    mem += 12.0 * cnn_zoo.model_params(model)   # params + optimizer state
    return mem < dev.mem_gb * 1e9 * 0.9


def measure(device: str, model: str, batch: int, pix: int,
            *, seed: int = 0) -> Measurement:
    from repro_torch.core import devices as _devices
    dev = _devices.get(device)  # helpful KeyError listing the catalog
    ops = cnn_zoo.build_ops(model, batch, pix)
    rng = _rng_for(seed, device, model, batch, pix)
    run_noise = float(np.exp(rng.normal(0.0, 0.03)))
    profiling_factor = float(rng.uniform(1.20, 1.30))

    profile: Dict[str, float] = {}
    total_us = 0.0
    for op in ops:
        t = op_latency_us(dev, op) * float(np.exp(rng.normal(0.0, 0.02)))
        total_us += t
        profile[op.name] = profile.get(op.name, 0.0) + t * profiling_factor
    profile = {k: v / 1e3 for k, v in profile.items()}   # ms
    latency_ms = total_us * run_noise / 1e3
    return Measurement(model=model, device=device, batch=batch, pix=pix,
                       profile=profile, latency_ms=latency_ms)

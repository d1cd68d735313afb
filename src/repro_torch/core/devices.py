"""Accelerator catalog: the paper's four AWS GPU instances (Table I), its two
unseen-device cases (Table VI), and TPU chips for the beyond-paper cross-chip
prophet. Specs are public; the behavioral parameters (op-launch overhead,
occupancy saturation, PCIe) parameterize the measurement simulator and are
calibrated to reproduce the paper's qualitative Fig-2 phenomena (non-linear
batch scaling, flat V100 curves, 10x best/worst spreads)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    kind: str                 # "gpu" | "tpu"
    peak_tflops: float        # fp32 for GPUs (paper Table I), bf16 for TPUs
    mem_bw_gbs: float
    mem_gb: float
    launch_us: float          # per-op dispatch overhead
    sat_gflop: float          # per-op work needed to saturate the device
    pcie_gbs: float           # host->device input pipeline bandwidth
    price_hr: float
    instance: str = ""


CATALOG: Dict[str, Device] = {d.name: d for d in [
    # --- paper Table I (training + anchor set) ---
    Device("M60", "gpu", 4.825, 160.0, 8.0, 9.0, 0.55, 6.0, 0.75, "g3s.xlarge"),
    Device("T4", "gpu", 8.141, 320.0, 16.0, 6.0, 0.80, 8.0, 0.526, "g4dn.xlarge"),
    Device("K80", "gpu", 4.113, 240.0, 12.0, 12.0, 0.40, 5.0, 0.90, "p2.xlarge"),
    Device("V100", "gpu", 14.13, 900.0, 16.0, 5.0, 2.20, 10.0, 3.06, "p3.2xlarge"),
    # --- paper Table VI (unseen targets) ---
    Device("A10", "gpu", 31.2, 600.0, 24.0, 4.0, 3.20, 12.0, 1.006, "g5.xlarge"),
    Device("P100", "gpu", 9.3, 732.0, 16.0, 7.0, 1.40, 8.0, 1.53, "ibm-ac1"),
    # --- beyond paper: TPU cross-chip prediction ---
    Device("TPUv4", "tpu", 275.0, 1228.0, 32.0, 2.0, 8.0, 40.0, 3.22),
    Device("TPUv5e", "tpu", 197.0, 819.0, 16.0, 2.0, 6.0, 40.0, 1.20),
    Device("TPUv5p", "tpu", 459.0, 2765.0, 95.0, 2.0, 12.0, 40.0, 4.20),
]}

PAPER_DEVICES = ("M60", "T4", "K80", "V100")
UNSEEN_DEVICES = ("A10", "P100")
TPU_DEVICES = ("TPUv4", "TPUv5e", "TPUv5p")


def get(name: str) -> Device:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; available: "
                       f"{', '.join(sorted(CATALOG))}") from None

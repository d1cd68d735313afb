"""Three-term roofline from the dry-run's per-device counts, ported from
``repro.analysis.roofline``:

    compute    = FLOPs / peak_FLOP/s
    memory     = HBM_bytes / HBM_bw
    collective = collective_bytes / link_bw

The FLOPs and bytes come from the aten-op counter
(``repro_torch.analysis.opcount``) run on one rank's shards, so the terms
are already per device; the "chips x" division applies to the global
``model_flops`` comparison only.

The constants are one NVIDIA H100 SXM's, from NVIDIA's H100 data sheet
(dense rates, without sparsity, at the full 700 W power limit), in place of
the reference's TPU v5e figures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM data sheet
PEAK_FLOPS = 989e12       # bf16 dense FLOP/s on the tensor cores
HBM_BW = 3.35e12          # HBM3 bytes/s
# One link rate, as the reference keeps one: the slowest link a group of the
# (16, 16) production mesh crosses. Its 16-wide "model" axis spans two
# 8-GPU nodes, so a group goes over InfiniBand NDR, 400 Gb/s = 50e9 bytes/s
# per GPU. Inside a node NVLink 4 gives 450e9 bytes/s each way.
LINK_BW = 50e9


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    collective_bytes_per_dev: float
    model_flops_global: float    # 6*N*D (dense) or 6*N_active*D (MoE)
    per_device_memory: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """No-overlap-free roofline: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        total_hlo = self.hlo_flops_per_dev * self.n_devices
        return self.model_flops_global / max(total_hlo, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-model-FLOPs MFU bound implied by the dominant term."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return (self.model_flops_global / self.n_devices) / (t * PEAK_FLOPS)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_memory": self.per_device_memory,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D with N = active params (excl. embeddings' lookup) per the
    assignment; decode shapes process 1 token per sequence."""
    n = cfg.param_count()
    if cfg.family == "moe":
        # active experts only
        dead = (cfg.num_experts - cfg.num_experts_per_tok) * \
            cfg.num_layers * 3 * cfg.d_model * cfg.d_ff
        n = n - dead
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens

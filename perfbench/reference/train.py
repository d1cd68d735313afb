"""The reference's first training steps: the family's model from the
seeded weights, AdamW, and the readings the benchmark compares with the
program's.

Readings of a run of ``steps`` optimizer steps:

- ``loss``: each step's loss (the mean over its microbatches);
- ``grad``: each parameter's norm of the first step's gradient as the
  optimizer took it (clipped), worked out from the first moment after
  that step, ``m / (1 - b1)``, as the moments were stored;
- ``update``: each parameter's norm of its change over the ``steps``.

With ``rows="half"`` each batch keeps only its first half of rows, the
mean taken over them: the benchmark's reading of a step that leaves half
of the batch out.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import common as C


def family(name: str):
    """The reference module of a model family (``reference/<family>.py``)."""
    return importlib.import_module(f"perfbench.reference.{name}")


def _tensors(batch: Dict[str, np.ndarray], device, rows: str):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    if rows == "half":
        out = {k: v[:v.shape[0] // 2] for k, v in out.items()}
    return out


def norms_by_group(specs, seed: int, params, device) -> Dict[str, float]:
    """Each parameter's norm of ``params[name] - start[name]``, the start
    drawn again from ``seed`` one group at a time."""
    out = {}
    for gname in C.groups(specs):
        start = C.init_params(specs, seed, device, only=(gname,))
        for name, p0 in start.items():
            out[name] = float(torch.linalg.vector_norm(
                params[name].detach().float() - p0))
        del start
    return out


def follow(model: dict, hp: dict, batches: List[Dict[str, np.ndarray]],
           seed: int, *, microbatches: int, device, prec: str = "float32",
           rows: str = "all") -> dict:
    """The readings of ``len(batches)`` reference steps from the weights of
    ``seed``; ``model`` and ``hp`` are the configuration's ``model`` and
    ``optimizer`` sections."""
    C.strict_float32()
    fam = family(model["family"])
    specs = fam.param_specs(model)
    params = {}
    for gname in C.groups(specs):
        for name, t in C.init_params(specs, seed, device, only=(gname,)).items():
            params[name] = t.clone().requires_grad_(True)
    opt = C.AdamW(params, hp, fam.decays)
    readings = {"loss": [], "grad_norm": []}
    for i, batch in enumerate(batches):
        batch = _tensors(batch, device, rows)
        size = batch["tokens"].shape[0] // microbatches
        loss = 0.0
        for j in range(microbatches):
            part = {k: v[j * size:(j + 1) * size] for k, v in batch.items()}
            loss += fam.accumulate_grads(params, model, part, prec,
                                         1.0 / microbatches)
        grads = {k: p.grad for k, p in params.items()}
        gnorm, _ = opt.update(params, grads)
        for p in params.values():
            p.grad = None
        del grads
        readings["loss"].append(loss)
        readings["grad_norm"].append(gnorm)
        if i == 0:
            readings["grad"] = {
                k: float(torch.linalg.vector_norm(m.float())) / (1 - hp["b1"])
                for k, m in opt.m.items()}
    del opt
    readings["update"] = norms_by_group(specs, seed, params, device)
    return readings

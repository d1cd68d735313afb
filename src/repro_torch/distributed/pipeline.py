"""GPipe-style pipeline parallelism over a mesh axis, ported from
``repro.distributed.pipeline``.

Maps a stack of L identical blocks onto S pipeline stages laid out along a
mesh axis (the multi-pod design point: stages over ``pod``). Microbatches
flow stage to stage by point-to-point sends along that axis; the schedule
is plain GPipe (fill, steady state, drain): T = M + S - 1 ticks for M
microbatches, bubble fraction (S-1)/T. The reference expresses the ticks
as a ``fori_loop`` of masked steps and a ring ``ppermute``; here each
stage walks its microbatches in order, receiving each from the stage
before and sending it on, so stage s works on microbatch t - s at tick t
by the data dependencies alone.

The utility is model-agnostic: it pipelines any ``block_fn(params_slice,
x) -> x`` whose stacked parameters have a leading layer axis.

Cost model (per microbatch of shape (mb, ...)): one send per stage
boundary — exactly the activations — and one broadcast of the last
stage's outputs so the result is on every stage.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist


def pipeline_apply(block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                      torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor],
                   x: torch.Tensor,
                   *,
                   mesh,
                   axis: str = "pod",
                   microbatches: int) -> torch.Tensor:
    """Apply L stacked blocks to ``x`` with pipeline parallelism.

    Every rank passes the whole ``stacked_params`` (a dict of tensors with
    leading dim L, L % S == 0; stage s uses layers [s*L/S, (s+1)*L/S)) and
    the whole ``x`` (B, ...) with B % microbatches == 0, as the reference's
    ``shard_map`` takes them replicated. Returns block_fn applied L times
    to x on every rank of ``mesh`` (a ``DeviceMesh``): the same ops in the
    same order as the sequential application, microbatch by microbatch.
    """
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    s = mesh.get_local_rank(axis)
    B, M = x.shape[0], microbatches
    assert B % M == 0, (B, M)
    L = next(iter(stacked_params.values())).shape[0]
    assert L % S == 0, (L, S)
    per = L // S
    local = {k: v[s * per:(s + 1) * per] for k, v in stacked_params.items()}

    def apply_stage(h):
        for i in range(per):
            h = block_fn({k: v[i] for k, v in local.items()}, h)
        return h

    xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
    outputs = torch.zeros_like(xm)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < S - 1 else None
    sends = []
    for m in range(M):
        if prev is None:
            h = xm[m]
        else:
            h = torch.empty_like(xm[m])
            dist.recv(h, src=prev, group=group)
        y = apply_stage(h)
        if nxt is None:
            outputs[m] = y
        else:
            y = y.contiguous()
            sends.append((dist.isend(y, dst=nxt, group=group), y))
    for work, _ in sends:
        work.wait()
    # only the last stage holds the outputs: broadcast them along the axis
    dist.broadcast(outputs, src=dist.get_global_rank(group, S - 1),
                   group=group)
    return outputs.reshape((B,) + tuple(x.shape[1:]))


def bubble_fraction(num_stages: int, microbatches: int) -> float:
    """GPipe pipeline bubble: (S-1) / (M + S - 1)."""
    return (num_stages - 1) / (microbatches + num_stages - 1)

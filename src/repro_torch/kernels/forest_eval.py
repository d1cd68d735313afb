"""Packed-forest batch inference on the card: evaluate stacked CART forests
over a block of rows in one launch.

Hand-written CUDA kernels (``repro_torch/csrc/forest_eval.cu``), each
with a plain PyTorch version beside it and launch counters:

  - :func:`leaf_values_grouped` — a stack of forests ``(G, T, N)``, every
    row routed through its own group's forest (``gid``) for at most that
    group's grown ``depth``. This is the ``ModelBank`` hot path: one launch
    per serving wave, whatever mix of (anchor, target) pairs it carries.
    Replaces ``repro.kernels.forest_eval.leaf_values_grouped_pallas``.
  - :func:`leaf_values` — one forest ``(T, N)``, the per-group path behind
    ``RandomForestRegressor.predict``. Replaces ``leaf_values_pallas``.
  - :func:`tree_mean` — the float64 mean over the tree axis, trees summed
    in order so a row's answer never depends on the other rows in the
    batch (``np.mean`` and ``torch.sum(dim=0)`` do not fix the order).
  - :func:`predict_grouped` / :func:`predict` — a traversal and its tree
    mean: on the shared route ONE launch of the traversal with the mean
    as its epilogue (``leaves_tile_kernel<*, true>``), on the global route
    the traversal, then ``tree_mean_kernel``.

Each traversal has two kernel routes, chosen by shape alone
(:func:`route_plan`):

  - shared (``leaves_tile_kernel``): one block per (tree, group, tile of
    :func:`tile_rows` rows) selects its group's rows of the tile, stages
    the tree and those rows in shared memory with ``cp.async`` and routes
    each row there. Taken where a tree and one row fit a block's shared
    memory (:func:`smem_bytes` against ``_build.SMEM_PER_BLOCK``) and the
    grid fits the card in one round of resident blocks
    (:func:`resident_blocks`), as for every serving wave of the paper
    grid.
  - global (``leaves_grouped_kernel`` / ``leaves_single_kernel``): one
    thread per (tree, row) walking out of L2; for a tree too large for
    shared memory or a wave too large for one round, where every block of
    the shared route would stage its tree and rows again.

Either route is one launch per call, counted under the traversal's name
(``"leaf_values_grouped"``, ``"leaf_values"``) or, for the global route,
that name + ``"/global"``. ``chip_smoke.py`` and the card tests compare
the two by calling each route's private launcher.

The fused predictions take the shared route where :func:`route_plan` does
for their own kernels (whose occupancy :func:`resident_blocks` reads with
``mean=True``) and count under ``"predict_grouped"`` / ``"predict"``;
elsewhere they launch the global traversal and then :func:`tree_mean`,
counted as those two. Their blocks write the leaves to a ``(T, rows)``
scratch; the last block of each row tile to finish (an ``atomicAdd`` on
one int32 counter per tile) adds the tile's trees in order and writes the
means. :func:`tile_counters` keeps the counters, one buffer per (device,
stream) so that launches which may overlap never share one; each launch
leaves them at zero, so launches in a row and CUDA-graph replays need no
memset.

Routing compares in float64, so both traversals are bitwise equal to the
reference's production path (``leaf_values_grouped_numpy`` /
``leaf_values_numpy``), and :func:`predict` / :func:`predict_grouped`
bitwise equal to ``repro``'s ``predict`` / ``predict_grouped``.

Dispatch (``backend``) as :mod:`repro_torch.kernels._build` describes it:
``"auto"`` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors. A failed launch raises; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import _build

# launches of each kernel route in this process (the plain versions count
# none)
launches: Dict[str, int] = {"leaf_values_grouped": 0,
                            "leaf_values_grouped/global": 0,
                            "leaf_values": 0, "leaf_values/global": 0,
                            "tree_mean": 0, "predict_grouped": 0,
                            "predict": 0}

# threads of a block of the shared route: the most rows one batch routes
TILE_THREADS = 128
# tile_rows stops growing at this many groups
TILE_GROUPS_MAX = 16
# the most blocks along the second and third grid dimensions
GRID_YZ_MAX = 65_535

_SIGNATURES = {
    # X, gid, feat, thr, left, right, value, depth, G, m, D, T, N, R, B,
    # smem, leaves, stream
    "forest_leaves_grouped": [ctypes.c_void_p] * 8
    + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 2,
    # X, feat, thr, left, right, value, depth, m, D, T, N, R, B, smem,
    # leaves, stream
    "forest_leaves": [ctypes.c_void_p] * 6
    + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 2,
    # the same with the tree mean: ... smem, leaves (scratch), done, out,
    # stream
    "forest_predict_grouped": [ctypes.c_void_p] * 8
    + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 4,
    "forest_predict": [ctypes.c_void_p] * 6
    + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 4,
    # grouped (0 or 1), mean (0 or 1), smem, blocks out
    "forest_tile_blocks_per_sm": [ctypes.c_longlong] * 3
    + [ctypes.POINTER(ctypes.c_int)],
    # the global route: the same as the shared one without R, B and smem
    "forest_leaves_grouped_global": [ctypes.c_void_p] * 8
    + [ctypes.c_longlong] * 5 + [ctypes.c_void_p] * 2,
    "forest_leaves_global": [ctypes.c_void_p] * 6
    + [ctypes.c_longlong] * 5 + [ctypes.c_void_p] * 2,
    # leaves, T, m, out, stream
    "forest_tree_mean": [ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_void_p],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from source at first use."""
    return _build.load("forest_eval", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _check_forest(X, feat, thr, left, right, value, lead: tuple) -> None:
    dev = X.device
    if X.dim() != 2:
        raise ValueError(f"X must be (rows, features); got {tuple(X.shape)}")
    _check("X", X, torch.float64, tuple(X.shape), dev)
    shape = tuple(feat.shape)
    if shape[:len(lead)] != lead or len(shape) != len(lead) + 2:
        raise ValueError(f"forest arrays must be {lead} + (T, N); got "
                         f"{shape}")
    _check("feat", feat, torch.int32, shape, dev)
    _check("thr", thr, torch.float64, shape, dev)
    _check("left", left, torch.int32, shape, dev)
    _check("right", right, torch.int32, shape, dev)
    _check("value", value, torch.float64, shape, dev)


# ---------------------------------------------------------------------------
# the choice of route
# ---------------------------------------------------------------------------


class TilePlan(NamedTuple):
    """Launch shape of the shared route: ``R`` rows per tile, ``B`` rows
    staged and routed per batch (grid ``(T, G, ceil(m / R))``) and ``smem``
    bytes of dynamic shared memory per block."""
    R: int
    B: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_rows(G: int) -> int:
    """The most rows one tile of the shared route holds: 128 per group, up
    to 16 groups. With a wave's rows spread over its groups a block then
    selects up to about 128 rows."""
    return TILE_THREADS * min(max(G, 1), TILE_GROUPS_MAX)


def smem_bytes(N: int, D: int, L: int, B: int) -> int:
    """Shared memory of one block of the shared route: the tree (feat,
    left, right int32; thr, value float64: 28 bytes a node), ``B`` staged
    rows of ``D`` float64, a list of ``L`` int32 row offsets and its int32
    count."""
    return 28 * N + 8 * B * D + 4 * L + 4


def tile_plan(G: int, T: int, N: int, m: int,
              D: int) -> Optional[TilePlan]:
    """The shared route's launch shape for ``m`` rows of ``D`` features
    over ``G`` forests of ``T`` trees of ``N`` nodes, or None where one
    tree and one row do not fit a block's shared memory
    (``_build.SMEM_PER_BLOCK``) or the grid would be too tall.

    Tiles of ``tile_rows(G)`` rows. A batch holds the rows a block selects
    when the tile's rows spread evenly over the ``G`` groups, rounded up to
    a warp and capped at 128, then shrunk to fit: a block with more rows
    routes them in more batches."""
    R = tile_rows(G)
    tiles = max(1, _cdiv(m, R))
    if G > GRID_YZ_MAX or tiles > GRID_YZ_MAX:
        return None
    L = min(R, m)
    B = max(1, min(TILE_THREADS, 32 * _cdiv(_cdiv(L, max(G, 1)), 32), L))
    B = min(B, (_build.SMEM_PER_BLOCK - smem_bytes(N, D, L, 0))
            // (8 * max(D, 1)))
    if B < 1:
        return None
    return TilePlan(R, B, smem_bytes(N, D, L, B))


def route_plan(G: int, T: int, N: int, m: int, D: int,
               resident: Callable[[int], int]) -> Optional[TilePlan]:
    """The plan of the shared route where a traversal takes it, else None
    (the global route): :func:`tile_plan` fits, and its ``T G ceil(m / R)``
    blocks fit the card in one round, ``resident(smem)`` being the blocks
    of ``smem`` bytes the card holds at once. Beyond one round the blocks
    that wait for an SM each stage a tree and their rows anew, and the
    shared route lost to the global one on the card (``PERF.md``)."""
    plan = tile_plan(G, T, N, m, D)
    if plan is None or T * G * _cdiv(m, plan.R) > resident(plan.smem):
        return None
    return plan


_RESIDENT: Dict[tuple, int] = {}


def resident_blocks(grouped: bool, smem: int, device, *,
                    mean: bool = False) -> int:
    """Blocks of the shared route's grouped (or single-forest) kernel, with
    the tree-mean epilogue if ``mean``, with ``smem`` bytes each that the
    card holds at once: its SMs times the blocks one SM holds, as the CUDA
    runtime reads them off the built kernel
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Cached per
    (device, kernel, smem)."""
    device = torch.device(device)
    key = (device.index, grouped, mean, smem)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = library().forest_tile_blocks_per_sm(
                int(grouped), int(mean), smem, ctypes.byref(per_sm))
        _build.raise_on(rc, "forest_tile_blocks_per_sm")
        _RESIDENT[key] = per_sm.value * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _RESIDENT[key]


_COUNTERS: Dict[tuple, torch.Tensor] = {}


def tile_counters(m: int, plan: TilePlan, device,
                  stream: int) -> torch.Tensor:
    """The per-row-tile counters of a fused launch of ``m`` rows with
    ``plan`` on ``stream`` (a CUDA stream handle) of ``device``: int32
    zeros, at least ``ceil(m / plan.R)`` of them. One buffer per (device,
    stream), kept across calls and grown to the tiles asked for when they
    outnumber it (the buffer it replaces is freed in that stream's order,
    after the launches queued on it); a launch leaves its counters at
    zero."""
    device = torch.device(device)
    key = (device.type, device.index, stream)
    tiles = _cdiv(m, plan.R)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTERS[key] = torch.zeros(tiles, dtype=torch.int32,
                                           device=device)
    return buf


def _launch(fn: str, key: str, X, T: int, *args,
            mean: Optional[TilePlan] = None) -> torch.Tensor:
    """Launch entry point ``fn`` (arguments ``args``, then the outputs and
    the stream); count it under ``key``. Into fresh ``(T, rows)`` leaves;
    or, with ``mean`` (the plan of a fused launch), into fresh ``(rows,)``
    means over a ``(T, rows)`` scratch of leaves, with the stream's tile
    counters."""
    m = X.shape[0]
    leaves = torch.empty((T, m), dtype=torch.float64, device=X.device)
    out = leaves if mean is None else torch.empty(
        m, dtype=torch.float64, device=X.device)
    if m == 0:
        return out
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        outs = (leaves.data_ptr(),) if mean is None else (
            leaves.data_ptr(),
            tile_counters(m, mean, X.device, stream).data_ptr(),
            out.data_ptr())
        rc = getattr(library(), fn)(*args, *outs, stream)
    _build.raise_on(rc, fn)
    launches[key] += 1
    return out


# ---------------------------------------------------------------------------
# grouped traversal (kernel 1)
# ---------------------------------------------------------------------------


def leaf_nodes_grouped_plain(X, gid, feat, thr, left, right, depth, *,
                             on_step=None) -> torch.Tensor:
    """The routing of the grouped plain version: ``(T, rows)`` flat offsets
    into the ``(G, T, N)`` forest arrays of the node each walk ends on.

    ``on_step(flat, F, within, go_left)``, if given, sees every level: the
    flat offsets of the current nodes, their features, whether the level is
    within the row's depth bound, and the outcome of ``x[F] <= thr``. A node
    is read (and routes on) where ``within`` holds; with ``F < 0`` it is a
    leaf and stays put. Rows whose ``gid`` lies outside ``[0, G)`` do not
    route."""
    m, D = X.shape
    G, T, N = feat.shape
    dev = X.device
    valid = (gid >= 0) & (gid < G)
    g = torch.where(valid, gid, 0)
    row_depth = torch.where(valid, depth[g], 0)
    base = (g[None, :] * T + torch.arange(T, device=dev)[:, None]) * N
    xbase = torch.arange(m, device=dev)[None, :] * D
    feat_f, thr_f = feat.reshape(-1), thr.reshape(-1)
    left_f, right_f = left.reshape(-1), right.reshape(-1)
    X_f = X.reshape(-1)
    nid = torch.zeros((T, m), dtype=torch.int64, device=dev)
    for step in range(int(depth.max()) if m else 0):
        flat = base + nid
        F = feat_f[flat].long()
        within = (row_depth > step)[None, :]
        TH = thr_f[flat]
        L = left_f[flat].long()
        R = right_f[flat].long()
        go_left = X_f[xbase + F.clamp(min=0)] <= TH
        if on_step is not None:
            on_step(flat, F, within, go_left)
        nid = torch.where(within & (F >= 0), torch.where(go_left, L, R), nid)
    return base + nid


def leaf_values_grouped_plain(X, gid, feat, thr, left, right, value,
                              depth) -> torch.Tensor:
    """Plain version of the grouped kernel: ``(T, rows)`` float64 leaf
    values, row ``r`` routed through forest ``gid[r]`` for at most
    ``depth[gid[r]]`` steps, the gathers written out over flat offsets. A
    row whose ``gid`` lies outside ``[0, G)`` gets NaN, as in the kernel."""
    nodes = leaf_nodes_grouped_plain(X, gid, feat, thr, left, right, depth)
    valid = (gid >= 0) & (gid < feat.shape[0])
    return torch.where(valid[None, :], value.reshape(-1)[nodes],
                       torch.full((), float("nan"), dtype=value.dtype,
                                  device=X.device))


def leaf_values_grouped(X, gid, feat, thr, left, right, value, depth, *,
                        backend: str = "auto") -> torch.Tensor:
    """Grouped traversal, ``(T, rows)`` float64 leaf values in row order.

    ``X`` float64 ``(m, D)``; ``gid`` int64 ``(m,)``; forest arrays
    ``(G, T, N)`` (feat/left/right int32, thr/value float64); ``depth``
    int64 ``(G,)``. The range of ``gid`` is checked on the card, not on
    the host (that would sync every wave): a row whose ``gid`` lies outside
    ``[0, G)`` reads no forest and gets NaN in every tree."""
    if not _build.use_kernel(X, backend, "forest_eval"):
        return leaf_values_grouped_plain(X, gid, feat, thr, left, right,
                                         value, depth)
    args = (X, gid, feat, thr, left, right, value, depth)
    plan = _grouped_plan(*args, mean=False)
    if plan is None:
        return _leaf_values_grouped_global(*args)
    return _leaf_values_grouped_shared(*args, plan)


def _grouped_plan(X, gid, feat, thr, left, right, value, depth, *,
                  mean: bool) -> Optional[TilePlan]:
    """Check the grouped kernels' arguments; the shared route's plan for
    the traversal (with ``mean``, for the fused prediction), or None for
    the global route."""
    _check_forest(X, feat, thr, left, right, value, (feat.shape[0],))
    G, T, N = feat.shape
    m, D = X.shape
    _check("gid", gid, torch.int64, (m,), X.device)
    _check("depth", depth, torch.int64, (G,), X.device)
    return route_plan(G, T, N, m, D, lambda smem: resident_blocks(
        True, smem, X.device, mean=mean))


def _leaf_values_grouped_shared(X, gid, feat, thr, left, right, value,
                                depth, plan: TilePlan) -> torch.Tensor:
    """The grouped traversal by the shared route with ``plan``, whatever
    the wave's size; arguments as :func:`leaf_values_grouped` checks them."""
    G, T, N = feat.shape
    return _launch("forest_leaves_grouped", "leaf_values_grouped", X, T,
                   *(a.data_ptr() for a in (X, gid, feat, thr, left, right,
                                            value, depth)),
                   G, *X.shape, T, N, *plan)


def _predict_grouped_shared(X, gid, feat, thr, left, right, value, depth,
                            plan: TilePlan) -> torch.Tensor:
    """The grouped prediction in one launch of the shared route with the
    tree-mean epilogue, with ``plan`` whatever the wave's size; arguments
    as :func:`leaf_values_grouped` checks them."""
    G, T, N = feat.shape
    return _launch("forest_predict_grouped", "predict_grouped", X, T,
                   *(a.data_ptr() for a in (X, gid, feat, thr, left, right,
                                            value, depth)),
                   G, *X.shape, T, N, *plan, mean=plan)


def _leaf_values_grouped_global(X, gid, feat, thr, left, right, value,
                                depth) -> torch.Tensor:
    """The grouped traversal by the global route; arguments as
    :func:`leaf_values_grouped` checks them."""
    G, T, N = feat.shape
    return _launch("forest_leaves_grouped_global",
                   "leaf_values_grouped/global", X, T,
                   *(a.data_ptr() for a in (X, gid, feat, thr, left, right,
                                            value, depth)),
                   G, *X.shape, T, N)


# ---------------------------------------------------------------------------
# single-forest traversal (kernel 2)
# ---------------------------------------------------------------------------


def leaf_values_plain(X, feat, thr, left, right, value,
                      depth: int) -> torch.Tensor:
    """Plain version of the single-forest kernel: the grouped traversal
    with one group and every row in it."""
    m = X.shape[0]
    return leaf_values_grouped_plain(
        X, torch.zeros(m, dtype=torch.int64, device=X.device), feat[None],
        thr[None], left[None], right[None], value[None],
        torch.tensor([int(depth)], dtype=torch.int64, device=X.device))


def leaf_values(X, feat, thr, left, right, value, *, depth: int,
                backend: str = "auto") -> torch.Tensor:
    """Single-forest traversal, ``(T, rows)`` float64 leaf values; forest
    arrays ``(T, N)``, ``depth`` the forest's grown depth."""
    if not _build.use_kernel(X, backend, "forest_eval"):
        return leaf_values_plain(X, feat, thr, left, right, value, depth)
    args = (X, feat, thr, left, right, value)
    plan = _single_plan(*args, mean=False)
    if plan is None:
        return _leaf_values_global(*args, depth=depth)
    return _leaf_values_shared(*args, depth=depth, plan=plan)


def _single_plan(X, feat, thr, left, right, value, *,
                 mean: bool) -> Optional[TilePlan]:
    """As :func:`_grouped_plan`, for the single-forest kernels."""
    _check_forest(X, feat, thr, left, right, value, ())
    m, D = X.shape
    T, N = feat.shape
    return route_plan(1, T, N, m, D, lambda smem: resident_blocks(
        False, smem, X.device, mean=mean))


def _leaf_values_shared(X, feat, thr, left, right, value, *, depth: int,
                        plan: TilePlan) -> torch.Tensor:
    """The single-forest traversal by the shared route with ``plan`` (the
    plan of one group), whatever the wave's size; arguments as
    :func:`leaf_values` checks them."""
    T, N = feat.shape
    return _launch("forest_leaves", "leaf_values", X, T,
                   *(a.data_ptr() for a in (X, feat, thr, left, right,
                                            value)),
                   int(depth), *X.shape, T, N, *plan)


def _predict_shared(X, feat, thr, left, right, value, *, depth: int,
                    plan: TilePlan) -> torch.Tensor:
    """The single-forest prediction in one launch of the shared route with
    the tree-mean epilogue (``plan`` of one group); arguments as
    :func:`leaf_values` checks them."""
    T, N = feat.shape
    return _launch("forest_predict", "predict", X, T,
                   *(a.data_ptr() for a in (X, feat, thr, left, right,
                                            value)),
                   int(depth), *X.shape, T, N, *plan, mean=plan)


def _leaf_values_global(X, feat, thr, left, right, value, *,
                        depth: int) -> torch.Tensor:
    """The single-forest traversal by the global route; arguments as
    :func:`leaf_values` checks them."""
    T, N = feat.shape
    return _launch("forest_leaves_global", "leaf_values/global", X, T,
                   *(a.data_ptr() for a in (X, feat, thr, left, right,
                                            value)),
                   int(depth), *X.shape, T, N)


# ---------------------------------------------------------------------------
# tree mean
# ---------------------------------------------------------------------------


def tree_mean_plain(vals: torch.Tensor) -> torch.Tensor:
    """Float64 mean over the tree axis of ``(T, rows)``, trees added one
    after another (the reference's ``tree_mean``). The divisor is a tensor:
    on CUDA, PyTorch divides by a Python scalar as a multiply by its
    reciprocal, which rounds differently from a true division."""
    acc = torch.zeros(vals.shape[1], dtype=torch.float64, device=vals.device)
    for t in range(vals.shape[0]):
        acc += vals[t]
    return acc / torch.full_like(acc, vals.shape[0])


def tree_mean(vals: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """``(rows,)`` float64 mean of ``(T, rows)`` float64 leaf values."""
    if not _build.use_kernel(vals, backend, "forest_eval"):
        return tree_mean_plain(vals)
    if vals.dim() != 2:
        raise ValueError(f"vals must be (T, rows); got {tuple(vals.shape)}")
    _check("vals", vals, torch.float64, tuple(vals.shape), vals.device)
    T, m = vals.shape
    out = torch.empty(m, dtype=torch.float64, device=vals.device)
    if m == 0:
        return out
    with torch.cuda.device(vals.device):
        rc = library().forest_tree_mean(
            vals.data_ptr(), T, m, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "forest_tree_mean")
    launches["tree_mean"] += 1
    return out


# ---------------------------------------------------------------------------
# forest prediction
# ---------------------------------------------------------------------------


def predict_plain(X, feat, thr, left, right, value,
                  depth: int) -> torch.Tensor:
    """Plain version of the fused single-forest kernel."""
    return tree_mean_plain(leaf_values_plain(X, feat, thr, left, right,
                                             value, depth))


def predict(X, feat, thr, left, right, value, *, depth: int,
            backend: str = "auto") -> torch.Tensor:
    """Forest prediction: float64 tree mean of the per-tree leaf values;
    arguments as :func:`leaf_values`. On the card one launch where the
    shared route is taken, else the global traversal and the tree mean."""
    if not _build.use_kernel(X, backend, "forest_eval"):
        return predict_plain(X, feat, thr, left, right, value, depth)
    args = (X, feat, thr, left, right, value)
    plan = _single_plan(*args, mean=True)
    if plan is None:
        return tree_mean(_leaf_values_global(*args, depth=depth))
    return _predict_shared(*args, depth=depth, plan=plan)


def predict_grouped_plain(X, gid, feat, thr, left, right, value,
                          depth) -> torch.Tensor:
    """Plain version of the fused grouped kernel."""
    return tree_mean_plain(leaf_values_grouped_plain(
        X, gid, feat, thr, left, right, value, depth))


def predict_grouped(X, gid, feat, thr, left, right, value, depth, *,
                    backend: str = "auto") -> torch.Tensor:
    """Grouped forest prediction: every row through its own group's
    forest; arguments as :func:`leaf_values_grouped`. On the card ONE
    launch where the shared route is taken (every serving wave of the
    paper grid), else the global traversal and the tree mean."""
    if not _build.use_kernel(X, backend, "forest_eval"):
        return predict_grouped_plain(X, gid, feat, thr, left, right, value,
                                     depth)
    args = (X, gid, feat, thr, left, right, value, depth)
    plan = _grouped_plan(*args, mean=True)
    if plan is None:
        return tree_mean(_leaf_values_grouped_global(*args))
    return _predict_grouped_shared(*args, plan)

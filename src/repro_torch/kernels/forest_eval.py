"""Packed-forest batch inference on the card: evaluate stacked CART forests
over a block of rows in one launch.

Three hand-written CUDA kernels (``repro_torch/csrc/forest_eval.cu``),
each with a plain PyTorch version beside it and a launch counter:

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
from typing import Dict

import torch

from repro_torch.kernels import _build

# launches of each kernel in this process (the plain versions count none)
launches: Dict[str, int] = {"leaf_values_grouped": 0, "leaf_values": 0,
                            "tree_mean": 0}

_SIGNATURES = {
    # X, gid, feat, thr, left, right, value, depth, G, m, D, T, N, leaves,
    # stream
    "forest_leaves_grouped": [ctypes.c_void_p] * 8
    + [ctypes.c_longlong] * 5 + [ctypes.c_void_p] * 2,
    # X, feat, thr, left, right, value, depth, m, D, T, N, leaves, stream
    "forest_leaves": [ctypes.c_void_p] * 6
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
    m = X.shape[0]
    _check_forest(X, feat, thr, left, right, value, (feat.shape[0],))
    G, T, N = feat.shape
    _check("gid", gid, torch.int64, (m,), X.device)
    _check("depth", depth, torch.int64, (G,), X.device)
    out = torch.empty((T, m), dtype=torch.float64, device=X.device)
    if m == 0:
        return out
    with torch.cuda.device(X.device):
        rc = library().forest_leaves_grouped(
            X.data_ptr(), gid.data_ptr(), feat.data_ptr(), thr.data_ptr(),
            left.data_ptr(), right.data_ptr(), value.data_ptr(),
            depth.data_ptr(), G, m, X.shape[1], T, N, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "forest_leaves_grouped")
    launches["leaf_values_grouped"] += 1
    return out


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
    _check_forest(X, feat, thr, left, right, value, ())
    m, D = X.shape
    T, N = feat.shape
    out = torch.empty((T, m), dtype=torch.float64, device=X.device)
    if m == 0:
        return out
    with torch.cuda.device(X.device):
        rc = library().forest_leaves(
            X.data_ptr(), feat.data_ptr(), thr.data_ptr(), left.data_ptr(),
            right.data_ptr(), value.data_ptr(), int(depth), m, D, T, N,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "forest_leaves")
    launches["leaf_values"] += 1
    return out


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


def predict(X, feat, thr, left, right, value, *, depth: int,
            backend: str = "auto") -> torch.Tensor:
    """Forest prediction: float64 tree mean of the per-tree leaf values."""
    return tree_mean(leaf_values(X, feat, thr, left, right, value,
                                 depth=depth, backend=backend),
                     backend=backend)


def predict_grouped(X, gid, feat, thr, left, right, value, depth, *,
                    backend: str = "auto") -> torch.Tensor:
    """Grouped forest prediction: every row through its own group's forest
    in ONE traversal launch, then one tree-mean launch."""
    return tree_mean(leaf_values_grouped(X, gid, feat, thr, left, right,
                                         value, depth, backend=backend),
                     backend=backend)

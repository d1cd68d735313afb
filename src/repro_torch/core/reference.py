"""Frozen pre-vectorisation reference implementations of the ensemble
training path, ported from ``repro.core.reference``.

Two jobs only — do NOT use these in production code:

  1. Oracle-equivalence checks: :class:`ReferenceForest` is a per-node
     recursive CART grower with split semantics bit-identical to the
     level-synchronous ``repro_torch.core.regressors.grow_forest`` (same
     bootstrap plan, same weighted SSE formula over the full row set, same
     tie-breaking), so the vectorized grower, and the forest kernels that
     walk its packed arrays, can be checked against a walk that never reads
     those arrays.
  2. The fit path's baseline: :func:`fit_profet_reference` replays the fit
     as it was before vectorisation — one recursive forest per (anchor,
     target) pair with row-duplication bootstrap (``bootstrap="rows"``), one
     sequential host-loop DNN fit per pair (with the old dropped-tail
     minibatch loop), so both the fit time and the held-out MAPE of today's
     ``Profet.fit`` are held against what the code did before.

The forest is host numpy, a copy of the reference's; the sequential DNN
is PyTorch on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import workloads
from repro_torch.core.ensemble import MedianEnsemble
from repro_torch.core.predictor import Profet
from repro_torch.core.regressors import (DNNRegressor, GAIN_TOL,
                                         LinearRegressor, VAR_TOL, _as_f32,
                                         _mlp_apply, _mlp_init, adam_update,
                                         bootstrap_plan)


@dataclasses.dataclass
class _RefNode:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class ReferenceForest:
    """Recursive CART bagging — the oracle the vectorized grower is tested
    against. Each node copies its sample subset and re-argsorts every
    feature (the pre-vectorisation cost profile). Candidate boundaries sit
    between consecutive distinct member values, exactly like the
    level-synchronous grower's node segments. Only ``max_features="all"``
    is supported.

    ``bootstrap`` picks the resampling semantics:

      - ``"weights"`` (default): the grower's per-sample weight plan
        (``bootstrap_plan``) — zero-weight rows stay in every node, so the
        grower and this oracle see identical candidate sets and agree on
        features/thresholds/structure bitwise (up to SSE ties within the
        last ulp; node values agree to the last ulp — different but
        equivalent summation order). The equivalence-check mode.
      - ``"rows"``: the bootstrap physically duplicates rows (``X[idx]``),
        so out-of-bag values never become thresholds. The fit baseline's
        mode: accuracy parity is measured against what the old code
        actually trained.

    ``predict`` walks every tree on the host, one row at a time.
    """

    def __init__(self, n_estimators: int = 100, max_depth: int = 24,
                 min_samples_leaf: int = 1, seed: int = 0,
                 bootstrap: str = "weights"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.bootstrap = bootstrap
        self.trees_: List[List[_RefNode]] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ReferenceForest":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        W, _ = bootstrap_plan(self.seed, self.n_estimators, len(y))
        self.trees_ = []
        for t in range(self.n_estimators):
            nodes: List[_RefNode] = []
            if self.bootstrap == "rows":
                rep = np.repeat(np.arange(len(y)), W[t].astype(np.int64))
                self._build(X[rep], y[rep], np.ones(len(rep)), 0, nodes)
            else:
                self._build(X, y, W[t], 0, nodes)
            self.trees_.append(nodes)
        return self

    def _build(self, X, y, w, depth, nodes) -> int:
        ml = float(self.min_samples_leaf)
        sw = w.sum()
        swy = (w * y).sum()
        swyy = (w * (y * y)).sum()
        node_id = len(nodes)
        nodes.append(_RefNode(value=swy / sw))
        base_sse = swyy - swy * swy / sw
        if depth >= self.max_depth or sw < 2 * ml \
                or not base_sse > VAR_TOL * sw:
            return node_id
        best_f, best_thr, best_sse = -1, 0.0, base_sse
        for f in range(X.shape[1]):
            o = np.argsort(X[:, f], kind="stable")
            xv = X[o, f]
            gap = xv[1:] > xv[:-1]
            if not gap.any():
                continue
            wo, yo = w[o], y[o]
            nl = np.cumsum(wo)[:-1]
            sl = np.cumsum(wo * yo)[:-1]
            ql = np.cumsum(wo * (yo * yo))[:-1]
            nr = sw - nl
            ok = gap & (nl >= ml) & (nr >= ml)
            sr = swy - sl
            qr = swyy - ql
            with np.errstate(divide="ignore", invalid="ignore"):
                sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
            sse = np.where(ok, sse, np.inf)
            kb = int(np.argmin(sse))
            if sse[kb] < best_sse - GAIN_TOL:
                best_f = f
                best_thr = 0.5 * (xv[kb] + xv[kb + 1])
                best_sse = sse[kb]
        if best_f < 0:
            return node_id
        node = nodes[node_id]
        node.feature, node.threshold = best_f, float(best_thr)
        mask = X[:, best_f] <= best_thr
        node.left = self._build(X[mask], y[mask], w[mask], depth + 1, nodes)
        node.right = self._build(X[~mask], y[~mask], w[~mask], depth + 1,
                                 nodes)
        return node_id

    def _tree_predict(self, nodes: List[_RefNode], X: np.ndarray):
        out = np.empty(len(X))
        for i, x in enumerate(X):
            nd = nodes[0]
            while nd.feature >= 0:
                nd = nodes[nd.left if x[nd.feature] <= nd.threshold
                           else nd.right]
            out[i] = nd.value
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        vals = np.stack([self._tree_predict(t, X) for t in self.trees_])
        return vals.mean(axis=0)

    def split_multiset(self):
        """Per tree: sorted (feature, threshold) pairs of internal nodes —
        structural fingerprint for the equivalence check."""
        return [sorted((n.feature, n.threshold) for n in t if n.feature >= 0)
                for t in self.trees_]


def fit_dnn_sequential(X: np.ndarray, y: np.ndarray, *, epochs: int = 400,
                       batch_size: int = 128, lr: float = 1e-3,
                       seed: int = 0, device="cuda",
                       init_params=None) -> DNNRegressor:
    """The old DNN fit: a host-side Python epoch/minibatch loop with one
    eager step per minibatch (no CUDA graph, no ``torch.compile``: the
    per-step dispatch is this baseline's cost, as the fresh ``jax.jit``
    trace per call was the reference's), and the dropped-tail batch bug
    (``range(0, n - bs + 1, bs)``) kept verbatim. ``init_params`` (one
    head's ``[{"w", "b"}, ...]``, arrays or tensors) replaces the seeded
    init, so a test can hand in the reference's initial weights."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    mu, sd = X.mean(0), X.std(0) + 1e-9
    ys = max(float(np.mean(np.abs(y))), 1e-9)
    Xn = ((X - mu) / sd).astype(np.float32)
    yn = (y / ys).astype(np.float32)

    single = (init_params if init_params is not None
              else _mlp_init(seed, X.shape[1], DNNRegressor.LAYERS, dev))
    params = [{k: _as_f32(layer[k], dev).clone().requires_grad_(True)
               for k in ("w", "b")} for layer in single]
    flat = [layer[k] for layer in params for k in ("w", "b")]
    m_state = [torch.zeros_like(p) for p in flat]
    v_state = [torch.zeros_like(p) for p in flat]
    lr32 = float(np.float32(lr))

    n = len(Xn)
    rng = np.random.default_rng(seed)
    Xd, yd = torch.from_numpy(Xn).to(dev), torch.from_numpy(yn).to(dev)
    bs = min(batch_size, n)
    t = 0
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(0, n - bs + 1, bs):
            idx = torch.from_numpy(perm[s:s + bs]).to(dev)
            xb, yb = Xd[idx], yd[idx]
            pred = _mlp_apply(params, xb)
            mape = torch.mean(torch.abs(pred - yb)
                              / torch.clamp(torch.abs(yb), min=1e-3))
            rmse = torch.sqrt(torch.mean((pred - yb) ** 2) + 1e-12)
            grads = torch.autograd.grad(mape + rmse, flat)
            t += 1
            adam_update(flat, grads, m_state, v_state, t, lr32)
    model = DNNRegressor(epochs=epochs, batch_size=batch_size, lr=lr,
                         seed=seed, device=dev)
    model.params = [{k: layer[k].detach() for k in ("w", "b")}
                    for layer in params]
    model._stats = (mu, sd, ys)
    return model


def fit_profet_reference(ds: "workloads.Dataset", cfg,
                         train_cases: Optional[Sequence] = None,
                         anchors: Optional[Sequence[str]] = None,
                         targets: Optional[Sequence[str]] = None,
                         device="cuda"):
    """The old ``Profet.fit``: one independently grown recursive forest and
    one sequential DNN per ordered (anchor, target) pair. Phases shared
    with the production path (features, phase-2 scalers) run through
    ``Profet`` itself so a comparison isolates the ensemble cost."""
    dev = resolve_device(device)
    p = Profet(cfg, device=dev)
    anchors = list(anchors or ds.devices)
    targets = list(targets or ds.devices)
    cases = list(train_cases or ds.cases)
    p._fit_features(ds, anchors, cases)
    for ga in anchors:
        X = p.feature_matrix([ds.profile(ga, c) for c in cases], cases)
        for gt in targets:
            if ga == gt:
                continue
            y = np.array([ds.latency(gt, c) for c in cases])
            prefit = {}
            for m in cfg.members:
                if m == "linear":
                    prefit[m] = LinearRegressor().fit(X, y)
                elif m == "forest":
                    prefit[m] = ReferenceForest(
                        n_estimators=cfg.n_trees, seed=cfg.seed,
                        bootstrap="rows").fit(X, y)
                elif m == "dnn":
                    prefit[m] = fit_dnn_sequential(
                        X, y, epochs=cfg.dnn_epochs, seed=cfg.seed,
                        device=dev)
            ens = MedianEnsemble(seed=cfg.seed, dnn_epochs=cfg.dnn_epochs,
                                 n_trees=cfg.n_trees, members=cfg.members,
                                 device=dev)
            p.cross[(ga, gt)] = ens.fit(X, y, prefit=prefit)
    p._fit_phase2(ds, anchors, targets, cases)
    return p

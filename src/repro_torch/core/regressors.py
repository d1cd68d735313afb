"""The three base regressors of PROFET's median ensemble (paper §III-C1),
ported from ``repro.core.regressors``:

  - LinearRegressor: least squares with bias, evaluated row-stably (numpy,
    copied as it is: float64 on the host, bitwise equal to the reference)
  - RandomForestRegressor: the level-synchronous CART grower and packed
    ``(feat, thr, left, right, value)`` arrays are copied as they are
    (numpy, on the host); ``predict`` runs the port's forest kernels
    (``repro_torch.kernels.forest_eval``) on the regressor's device
  - DNNRegressor: 128x64x32x16x1 ReLU MLP, Adam(1e-3), MAPE+RMSE loss, in
    PyTorch; all targets of one anchor train jointly in ``fit_dnn_multi``
    with stacked ``(K, d_in, d_out)`` weights and ``torch.bmm``
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

FOREST_PACK_SCHEMA = 2


class LegacyForestError(RuntimeError):
    """A pickle carries a pre-packed (node-list) forest; refit required."""


class LinearRegressor:
    """Ordinary least squares with intercept (ridge-stabilized)."""

    def __init__(self, l2: float = 1e-8):
        self.l2 = l2
        self.coef_: Optional[np.ndarray] = None

    @staticmethod
    def _design(X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        Xb = np.empty((X.shape[0], X.shape[1] + 1))
        Xb[:, :-1] = X
        Xb[:, -1] = 1.0
        return Xb

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearRegressor":
        Xb = self._design(X)
        A = Xb.T @ Xb + self.l2 * np.eye(Xb.shape[1])
        self.coef_ = np.linalg.solve(A, Xb.T @ y)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.apply(self._design(X), self.coef_)

    @staticmethod
    def apply(design: np.ndarray, coef: np.ndarray) -> np.ndarray:
        """Row-stable evaluation: elementwise product + contiguous-axis sum
        instead of a BLAS gemv. A gemv's reduction blocking changes with the
        row count, so slicing rows out of a bigger matrix changes last-ulp
        results; this form reduces each row independently, which lets the
        stacked bank path (``coef`` per row) match per-group prediction
        bit-for-bit. ``coef`` broadcasts: ``(D+1,)`` or ``(rows, D+1)``."""
        return (design * coef).sum(axis=1)


# ---------------------------------------------------------------------------
# Random forest: level-synchronous vectorized CART grower
# ---------------------------------------------------------------------------

# Split-selection tolerances shared with repro.core.reference — both
# implementations must make bit-identical choices.
GAIN_TOL = 1e-12
VAR_TOL = 1e-18


@dataclasses.dataclass
class PackedForest:
    """A whole forest as flat arrays, shape (n_trees, max_nodes).

    ``feat[t, i] < 0`` marks a leaf; internal nodes route ``x[feat] <= thr``
    to ``left`` else ``right``. ``depth`` is the number of levels actually
    grown — the exact traversal bound for the inference kernels.
    """

    feat: np.ndarray      # int32  (T, N)
    thr: np.ndarray       # float64(T, N)
    left: np.ndarray      # int32  (T, N)
    right: np.ndarray     # int32  (T, N)
    value: np.ndarray     # float64(T, N)
    n_nodes: np.ndarray   # int64  (T,)
    depth: int

    _FIELDS = ("feat", "thr", "left", "right", "value", "n_nodes")

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    def to_state(self) -> dict:
        state = {k: getattr(self, k) for k in self._FIELDS}
        state["depth"] = int(self.depth)
        return state

    @classmethod
    def from_state(cls, state: dict) -> "PackedForest":
        missing = [k for k in cls._FIELDS + ("depth",) if k not in state]
        if missing:
            raise LegacyForestError(
                f"packed forest state missing fields {missing}; refit")
        return cls(**{k: np.asarray(state[k]) for k in cls._FIELDS},
                   depth=int(state["depth"]))


def bootstrap_plan(seed: int, n_trees: int, n: int):
    """Per-tree bootstrap expressed as sample *weights* over the shared row
    set (multiplicity counts), plus the derived feature-subsampling seed.
    One deterministic plan shared by the vectorized grower and the recursive
    reference, so both grow identical forests at a fixed seed."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_trees, n))
    W = np.zeros((n_trees, n), np.float64)
    rows = np.repeat(np.arange(n_trees), n)
    np.add.at(W, (rows, idx.ravel()), 1.0)
    return W, int(rng.integers(1 << 31))


def grow_forest(X: np.ndarray, y: np.ndarray, W: np.ndarray, *,
                max_depth: int, min_samples_leaf: int = 1,
                n_candidate_features: Optional[int] = None,
                feature_seed: int = 0) -> PackedForest:
    """Grow every tree of the forest one depth at a time.

    All frontier nodes of all trees are scored in a single pass per level.
    Per feature, every tree's samples are regrouped node-contiguously over
    the SHARED sorted-feature index (one stable argsort per feature at fit
    start, one per-row segment sort per level — never a per-node argsort),
    and one cumulative-sum sweep scores every candidate boundary of every
    frontier node at once. Cost per level is O(trees x samples x features),
    independent of how many frontier nodes the level has. Split semantics
    match ``repro.core.reference.ReferenceForest`` (the recursive oracle):
    identical candidate boundaries, thresholds, and tie-breaking — exact up
    to SSE rounding in the last ulp (per-node prefix sums here are global
    cumsum differences, the reference accumulates per subset; candidates
    whose SSEs collide within that ulp could resolve differently).
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    W = np.asarray(W, np.float64)
    T, n = W.shape
    d = X.shape[1]
    ml = float(min_samples_leaf)
    k_feats = d if n_candidate_features is None else min(n_candidate_features, d)
    frng = np.random.default_rng(feature_seed)

    sort_idx = np.argsort(X, axis=0, kind="stable")      # (n, d)

    cap = 2 * n + 1
    feat = np.full((T, cap), -1, np.int32)
    thr = np.zeros((T, cap))
    left = np.full((T, cap), -1, np.int32)
    right = np.full((T, cap), -1, np.int32)
    value = np.zeros((T, cap))
    n_nodes = np.ones(T, np.int64)
    node_of = np.zeros((T, n), np.int64)
    depth_grown = 0
    y2 = y * y
    tree_rows = np.arange(T)[:, None]

    ft = np.arange(T)                 # frontier: tree ids ...
    fn = np.zeros(T, np.int64)        # ... and node ids, sorted by (tree, node)
    for depth in range(max_depth + 1):
        if ft.size == 0:
            break
        # per-slot stats, computed densely (pairwise row sums — matches the
        # recursive reference to the last ulp of each node's member sum)
        Wn = np.where(node_of[ft] == fn[:, None], W[ft], 0.0)    # (S, n)
        sw = Wn.sum(axis=1)
        swy = (Wn * y).sum(axis=1)
        swyy = (Wn * y2).sum(axis=1)
        value[ft, fn] = swy / sw
        if depth == max_depth:
            break
        base_sse = swyy - swy * swy / sw
        can = (sw >= 2 * ml) & (base_sse > VAR_TOL * sw)
        if not can.any():
            break
        ft, fn = ft[can], fn[can]
        sw, swy, swyy = sw[can], swy[can], swyy[can]
        S = ft.size

        best_sse = base_sse[can]      # a split must strictly beat the parent
        best_f = np.full(S, -1, np.int64)
        best_thr = np.zeros(S)
        allowed = None
        if k_feats < d:
            # per-node feature subsets, k smallest of a uniform draw
            r = frng.random((S, d))
            kth = np.partition(r, k_feats - 1, axis=1)[:, k_feats - 1:k_feats]
            allowed = r <= kth

        # slot id of every sample's current node (S = sentinel: not in a
        # splittable node), plus slot totals padded for sentinel gathers
        slot_map = np.full((T, cap), S, np.int64)
        slot_map[ft, fn] = np.arange(S)
        slot_of = np.take_along_axis(slot_map, node_of, axis=1)   # (T, n)
        sw_pad = np.concatenate([sw, [0.0]])
        swy_pad = np.concatenate([swy, [0.0]])
        swyy_pad = np.concatenate([swyy, [0.0]])

        flat = np.arange(T * n)
        is_row_start = (flat % n) == 0
        not_last_col = (flat % n) != n - 1
        for f in range(d):
            # regroup each tree's row node-contiguously, preserving the
            # global x-sorted order inside each node segment
            g = slot_of[:, sort_idx[:, f]]                   # (T, n)
            perm = np.argsort(g, axis=1, kind="stable")
            idx = sort_idx[:, f][perm]                       # sample ids
            gp = np.take_along_axis(g, perm, axis=1).ravel()
            wp = np.take_along_axis(W, idx, axis=1)
            xp = X[idx, f].ravel()
            yp = y[idx]

            cw = np.cumsum(wp, axis=1).ravel()
            cwy = np.cumsum(wp * yp, axis=1).ravel()
            cwyy = np.cumsum(wp * y2[idx], axis=1).ravel()

            starts = np.flatnonzero(is_row_start |
                                    (gp != np.roll(gp, 1)))
            seg_id = np.cumsum(is_row_start | (gp != np.roll(gp, 1))) - 1
            head = starts - 1                                 # cumsum offset
            hw = np.where(starts % n == 0, 0.0, cw[head])[seg_id]
            hwy = np.where(starts % n == 0, 0.0, cwy[head])[seg_id]
            hwyy = np.where(starts % n == 0, 0.0, cwyy[head])[seg_id]

            nl = cw - hw
            sl = cwy - hwy
            ql = cwyy - hwyy
            tot_w = sw_pad[gp]
            nr = tot_w - nl
            ok = (not_last_col & (gp < S)
                  & (np.roll(gp, -1) == gp)
                  & (np.roll(xp, -1) > xp)
                  & (nl >= ml) & (nr >= ml))
            sr = swy_pad[gp] - sl
            qr = swyy_pad[gp] - ql
            with np.errstate(divide="ignore", invalid="ignore"):
                sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
            sse = np.where(ok, sse, np.inf)

            seg_min = np.minimum.reduceat(sse, starts)
            is_min = sse <= seg_min[seg_id]
            pos = np.where(is_min, flat, T * n)
            seg_pos = np.minimum.reduceat(pos, starts)

            slot_seg = gp[starts]
            real = slot_seg < S
            sl_ids = slot_seg[real]
            cand = seg_min[real]
            better = cand < best_sse[sl_ids] - GAIN_TOL
            if allowed is not None:
                better &= allowed[sl_ids, f]
            if not better.any():
                continue
            win_slots = sl_ids[better]
            p_star = seg_pos[real][better]
            best_f[win_slots] = f
            best_thr[win_slots] = 0.5 * (xp[p_star] + xp[p_star + 1])
            best_sse[win_slots] = cand[better]

        win = np.flatnonzero(best_f >= 0)
        if win.size == 0:
            break
        depth_grown = depth + 1
        wt, wnid = ft[win], fn[win]            # already sorted by (tree, node)
        uniq_t, first, counts = np.unique(wt, return_index=True,
                                          return_counts=True)
        j = np.arange(wt.size) - np.repeat(first, counts)
        lid = n_nodes[wt] + 2 * j
        rid = lid + 1
        feat[wt, wnid] = best_f[win].astype(np.int32)
        thr[wt, wnid] = best_thr[win]
        left[wt, wnid] = lid.astype(np.int32)
        right[wt, wnid] = rid.astype(np.int32)
        n_nodes[uniq_t] += 2 * counts

        # route every sample one step down its (possibly just-split) node
        F = np.take_along_axis(feat, node_of, axis=1).astype(np.int64)
        TH = np.take_along_axis(thr, node_of, axis=1)
        L = np.take_along_axis(left, node_of, axis=1).astype(np.int64)
        R = np.take_along_axis(right, node_of, axis=1).astype(np.int64)
        xf = X[np.arange(n)[None, :], np.maximum(F, 0)]
        node_of = np.where(F >= 0, np.where(xf <= TH, L, R), node_of)

        ft = np.repeat(wt, 2)
        fn = np.stack([lid, rid], axis=1).ravel()

    used = int(n_nodes.max())
    return PackedForest(feat=feat[:, :used], thr=thr[:, :used],
                        left=left[:, :used], right=right[:, :used],
                        value=value[:, :used], n_nodes=n_nodes,
                        depth=depth_grown)


class RandomForestRegressor:
    """Bagging + per-node feature subsampling (sklearn-default-like:
    n_estimators=100, max_features=1.0 for regression, bootstrap). The whole
    forest is grown on the host in one level-synchronous pass and stored
    packed; ``predict`` routes rows through it with the single-forest
    kernel on ``device``."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 24,
                 min_samples_leaf: int = 1, max_features: str = "all",
                 seed: int = 0, device="cuda"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.device = resolve_device(device)
        self.forest_: Optional[PackedForest] = None
        self._on_device = (None, None)    # (forest_, its device tensors)

    def _mf(self, nfeat: int) -> Optional[int]:
        if self.max_features == "sqrt":
            return max(1, int(np.sqrt(nfeat)))
        if self.max_features == "third":
            return max(1, nfeat // 3)
        return None                     # "all": no subsampling

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        W, feature_seed = bootstrap_plan(self.seed, self.n_estimators, len(y))
        self.forest_ = grow_forest(
            X, y, W, max_depth=self.max_depth,
            min_samples_leaf=self.min_samples_leaf,
            n_candidate_features=self._mf(X.shape[1]),
            feature_seed=feature_seed)
        return self

    def device_forest(self) -> dict:
        """The packed arrays as tensors on ``device`` (copied once per
        fitted forest)."""
        f = self.forest_
        if self._on_device[0] is not f:
            self._on_device = (f, {
                k: torch.from_numpy(np.ascontiguousarray(getattr(f, k))
                                    ).to(self.device)
                for k in ("feat", "thr", "left", "right", "value")})
        return self._on_device[1]

    def predict(self, X: np.ndarray) -> np.ndarray:
        from repro_torch.kernels import forest_eval
        t = self.device_forest()
        x = torch.from_numpy(np.ascontiguousarray(X, np.float64)
                             ).to(self.device)
        return forest_eval.predict(
            x, t["feat"], t["thr"], t["left"], t["right"], t["value"],
            depth=self.forest_.depth).cpu().numpy()


# ---------------------------------------------------------------------------
# DNN regressor (PyTorch): K heads trained jointly as stacked weights
# ---------------------------------------------------------------------------


def _mlp_init(seed: int, d: int, layers: Tuple[int, ...], device="cuda"):
    """He-normal weights (std ``sqrt(2 / fan_in)``) and zero biases, drawn
    from a CPU ``torch.Generator`` so the init does not depend on the
    device. (``jax.random`` draws other numbers from the same seed.)"""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    sizes = (d,) + tuple(layers)
    params = []
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=gen,
                        dtype=torch.float32) * math.sqrt(2.0 / sizes[i])
        params.append({"w": w.to(dev),
                       "b": torch.zeros(sizes[i + 1], dtype=torch.float32,
                                        device=dev)})
    return params


def _mlp_apply(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


def _mlp_apply_stacked(params, x):
    """K heads at once: weights ``(K, d_in, d_out)``, biases ``(K, d_out)``,
    ``x`` ``(K, rows, d)``; returns ``(K, rows)``."""
    h = x
    for i, layer in enumerate(params):
        h = torch.bmm(h, layer["w"]) + layer["b"][:, None, :]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


def epoch_batches(rng: np.random.Generator, n: int, batch_size: int,
                  epochs: int) -> np.ndarray:
    """Minibatch index plan: (epochs * ceil(n/bs), bs) int array.

    Every epoch covers EVERY sample: the tail batch is wrap-padded with the
    head of that epoch's permutation instead of being dropped (a loop over
    ``range(0, n - bs + 1, bs)`` would silently skip up to bs-1 samples
    per epoch whenever ``n % bs != 0``)."""
    bs = min(batch_size, n)
    nb = -(-n // bs)
    out = np.empty((epochs, nb, bs), np.int64)
    for e in range(epochs):
        perm = rng.permutation(n)
        if nb * bs > n:
            perm = np.concatenate([perm, perm[:nb * bs - n]])
        out[e] = perm.reshape(nb, bs)
    return out.reshape(epochs * nb, bs)



def _as_f32(a, dev: torch.device) -> torch.Tensor:
    """A float32 tensor on ``dev`` from a tensor or (copied) array."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(dev, torch.float32)


def fit_dnn_multi(X: np.ndarray, Y: np.ndarray, *, epochs: int = 400,
                  batch_size: int = 128, lr: float = 1e-3, seed: int = 0,
                  device="cuda", init_params=None) -> List["DNNRegressor"]:
    """Train one MLP head per row of ``Y`` (K targets) against the SHARED
    feature matrix ``X``: the K heads are stacked ``(K, d_in, d_out)``
    weights trained together with ``torch.bmm``, over the same
    ``epoch_batches`` plan as the reference. ``init_params`` (one head's
    ``[{"w", "b"}, ...]``, broadcast to all K) replaces the seeded init,
    so a test can hand in the reference's initial weights.

    Adam is written out as the reference writes it (``b1=0.9, b2=0.999,
    eps=1e-8``; bias-corrected ``mh``, ``vh``; ``p - lr*mh/(sqrt(vh)+eps)``)
    rather than taken from ``torch.optim.Adam``, which places ``eps``
    differently."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    K, n = Y.shape
    mu, sd = X.mean(0), X.std(0) + 1e-9
    ys = np.maximum(np.abs(Y).mean(axis=1), 1e-9)        # (K,)
    Xd = torch.from_numpy(((X - mu) / sd).astype(np.float32)).to(dev)
    Yd = torch.from_numpy((Y / ys[:, None]).astype(np.float32)).to(dev)

    single = (init_params if init_params is not None
              else _mlp_init(seed, X.shape[1], DNNRegressor.LAYERS, dev))
    params = [{k: _as_f32(layer[k], dev)
               .expand((K,) + tuple(layer[k].shape)).clone()
               .requires_grad_(True) for k in ("w", "b")}
              for layer in single]
    flat = [layer[k] for layer in params for k in ("w", "b")]
    m_state = [torch.zeros_like(p) for p in flat]
    v_state = [torch.zeros_like(p) for p in flat]
    batches = torch.from_numpy(epoch_batches(np.random.default_rng(seed), n,
                                             batch_size, epochs)).to(dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr32 = float(np.float32(lr))
    for step in range(batches.shape[0]):
        idx = batches[step]
        xb = Xd[idx].expand(K, -1, -1)
        yb = Yd[:, idx]
        pred = _mlp_apply_stacked(params, xb)                # (K, bs)
        mape = (torch.abs(pred - yb)
                / torch.clamp(torch.abs(yb), min=1e-3)).mean(dim=1)
        rmse = torch.sqrt(((pred - yb) ** 2).mean(dim=1) + 1e-12)
        # heads share no parameter, so the gradient of the summed loss is
        # each head's own gradient
        grads = torch.autograd.grad((mape + rmse).sum(), flat)
        t = np.float32(step + 1)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(flat, grads)):
                m_ = b1 * m_state[j] + (1 - b1) * g
                v_ = b2 * v_state[j] + (1 - b2) * g * g
                m_state[j], v_state[j] = m_, v_
                mh = m_ / c1
                vh = v_ / c2
                p.copy_(p - lr32 * mh / (torch.sqrt(vh) + eps))

    models = []
    for k in range(K):
        m = DNNRegressor(epochs=epochs, batch_size=batch_size, lr=lr,
                         seed=seed, device=dev)
        m.params = [{n_: layer[n_][k].detach().clone() for n_ in ("w", "b")}
                    for layer in params]
        m._stats = (mu, sd, float(ys[k]))
        models.append(m)
    return models


class DNNRegressor:
    """Paper's MLP: dense 128-64-32-16-1 with ReLU, Adam(lr=1e-3), loss =
    MAPE + RMSE (combined, as in §III-C1). Inputs are z-scored and the target
    scaled by its mean internally. ``fit`` is the K=1 case of
    :func:`fit_dnn_multi`."""

    LAYERS = (128, 64, 32, 16, 1)

    def __init__(self, epochs: int = 400, batch_size: int = 128,
                 lr: float = 1e-3, seed: int = 0, device="cuda"):
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self.params = None
        self._stats = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "DNNRegressor":
        fitted = fit_dnn_multi(X, np.asarray(y)[None, :], epochs=self.epochs,
                               batch_size=self.batch_size, lr=self.lr,
                               seed=self.seed, device=self.device)[0]
        self.params, self._stats = fitted.params, fitted._stats
        return self

    # rows are padded to power-of-two buckets (>= 8) before the apply, as
    # in the reference, so a wave of any size reuses one of a bounded set
    # of matrix-product shapes (warmed by ``ModelBank.warmup``)
    PREDICT_BUCKET_MIN = 8

    def predict(self, X: np.ndarray) -> np.ndarray:
        mu, sd, ys = self._stats
        Xn = ((np.asarray(X) - mu) / sd).astype(np.float32)
        n = Xn.shape[0]
        m = bucket(n, self.PREDICT_BUCKET_MIN)
        if m != n:
            Xn = np.pad(Xn, ((0, m - n), (0, 0)))
        with torch.no_grad():
            out = _mlp_apply(self.params,
                             torch.from_numpy(Xn).to(self.device))
        return out.cpu().numpy()[:n] * ys


# ---------------------------------------------------------------------------
# stacked multi-head apply (ModelBank hot path)
# ---------------------------------------------------------------------------


def bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — THE shape-bucketing rule
    shared by ``DNNRegressor.predict`` and the ModelBank's stacked apply,
    so the matrix products of any wave come from one bounded shape set."""
    return max(floor, 1 << max(n - 1, 0).bit_length())


def stack_dnn_heads(models: List["DNNRegressor"], device="cuda"):
    """Stack fitted DNN heads for the bank: params with a leading group
    axis on ``device``, ``(G, D)`` z-score mu/sd, and the float32 per-head
    target scales (float32 so the bank's denormalization ``out_f32 *
    ys_f32`` reproduces ``DNNRegressor.predict``'s float32 multiply
    exactly)."""
    dev = resolve_device(device)
    params = [{k: torch.stack([m.params[i][k] for m in models]).to(dev)
               for k in ("w", "b")} for i in range(len(models[0].params))]
    mu = np.stack([m._stats[0] for m in models])
    sd = np.stack([m._stats[1] for m in models])
    ys = np.array([m._stats[2] for m in models], np.float32)
    return params, mu, sd, ys


def mlp_apply_multi(params, gidx: torch.Tensor,
                    block: torch.Tensor) -> torch.Tensor:
    """Stacked-head apply: gather the heads ``gidx`` selects out of the
    full stack on the device, then one ``bmm`` chain over the dense
    ``(groups, rows, features)`` block; returns ``(groups, rows)``."""
    picked = [{k: layer[k][gidx] for k in ("w", "b")} for layer in params]
    with torch.no_grad():
        return _mlp_apply_stacked(picked, block)

"""``ModelBank`` — every fitted (anchor, target) ensemble packed into
stacked tensors for single-dispatch wave execution.

  - **forest stack** — all pairs' packed forests in one ``(G, T, N_max)``
    tensor set on the device (pad nodes are leaves: ``feat = -1`` self-loops
    are never reached because routing starts at node 0), plus the per-group
    ``depth`` vector. A wave's rows — any mix of pairs — route through
    ``kernels.forest_eval.predict_grouped``: ONE grouped traversal launch
    and one tree-mean launch for the whole wave.
  - **DNN stack** — all heads' weights stacked on the device with a leading
    group axis, plus stacked z-score/target-scale stats on the host; a wave
    pays ONE ``mlp_apply_multi`` call on a ``(groups, rows, features)``
    block, bucket-padded once per wave.
  - **linear + phase-2 stacks** — ``(G, D+1)`` least-squares coefficients
    applied row-stably (``LinearRegressor.apply``), the median, and the
    per-device polynomial scaler coefficients evaluated with one Horner
    pass. These stay numpy on the host, as in the reference, so they stay
    bit for bit equal to it.

Equality bar: routing, the row-stable linear form, the tree-sequential
tree mean, the median and Horner evaluation are all per-row operations, so
stacked answers match the per-group executor path bit for bit for the
float64 members; the float32 DNN member agrees to float32 precision.

Ensembles carrying members the bank cannot stack raise
:class:`BankUnsupportedError` and the executor falls back to the per-group
path.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.regressors import (DNNRegressor, LinearRegressor,
                                         RandomForestRegressor, bucket,
                                         mlp_apply_multi, stack_dnn_heads)
from repro_torch.kernels import forest_eval


class BankUnsupportedError(RuntimeError):
    """The fitted model cannot be packed (unexpected member types or
    heterogeneous shapes); callers fall back to per-group execution."""


def host_array(t: torch.Tensor) -> np.ndarray:
    """A stacked tensor copied to a contiguous host numpy array."""
    return np.ascontiguousarray(t.detach().cpu().numpy())


def device_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: a view of ``a`` on the CPU
    when ``a`` is writable, else a copy (read-only received buffers)."""
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class ModelBank:
    """Stacked ensembles over the trained pair set of one ``Profet``.

    ``forest_launches`` / ``mlp_applies`` count fused dispatches over the
    bank's lifetime: exactly one of each per banked wave.
    """

    def __init__(self, pairs: Sequence[Tuple[str, str]],
                 members: Tuple[str, ...], n_features: int,
                 forest: Optional[dict], lin_coef: Optional[np.ndarray],
                 dnn: Optional[tuple], devices: Tuple[str, ...],
                 scalers: Dict[str, tuple], device="cuda"):
        self.pairs = tuple(pairs)
        self.gid = {p: i for i, p in enumerate(self.pairs)}
        self.members = members
        self.n_features = n_features
        self.forest = forest          # feat/thr/left/right/value/depth tensors
        self.lin_coef = lin_coef      # (G, D+1) numpy
        self.dnn = dnn                # (params on device, mu, sd, ys_f32)
        self.devices = devices
        self.dev_id = {d: i for i, d in enumerate(devices)}
        self.scalers = scalers        # kind -> (coef (n_dev, k), lo, hi)
        self.device = resolve_device(device)
        self.forest_launches = 0
        self.mlp_applies = 0
        self.warmup_ms = 0.0

    @property
    def n_groups(self) -> int:
        return len(self.pairs)

    def supports(self, pairs: Iterable[Tuple[str, str]]) -> bool:
        return all(p in self.gid for p in pairs)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, profet) -> "ModelBank":
        """Pack every fitted pair of ``profet`` into the stacked tensors on
        ``profet.device``. Raises :class:`BankUnsupportedError` when any
        ensemble holds a member the bank cannot stack."""
        dev = profet.device
        pairs = sorted(profet.cross)
        if not pairs:
            raise BankUnsupportedError("no trained (anchor, target) pairs")
        members = None
        for pair in pairs:
            ens = profet.cross[pair]
            if members is None:
                members = tuple(ens.members)
            elif tuple(ens.members) != members:
                raise BankUnsupportedError(
                    f"heterogeneous member sets across pairs: "
                    f"{members} vs {tuple(ens.members)} ({pair})")
        known = {"linear", "forest", "dnn"}
        if not set(members) <= known:
            raise BankUnsupportedError(
                f"unstackable members {set(members) - known}")

        forest = lin_coef = dnn = None
        n_features = -1
        if "linear" in members:
            coefs = []
            for pair in pairs:
                lin = profet.cross[pair].models["linear"]
                if not isinstance(lin, LinearRegressor) or lin.coef_ is None:
                    raise BankUnsupportedError(
                        f"linear member of {pair} is "
                        f"{type(lin).__name__}, not a fitted "
                        "LinearRegressor")
                coefs.append(np.asarray(lin.coef_, np.float64))
            if len({c.shape for c in coefs}) != 1:
                raise BankUnsupportedError("linear coef shapes differ")
            lin_coef = np.stack(coefs)
            n_features = lin_coef.shape[1] - 1
        if "forest" in members:
            packed = []
            for pair in pairs:
                rf = profet.cross[pair].models["forest"]
                if not isinstance(rf, RandomForestRegressor) \
                        or rf.forest_ is None:
                    raise BankUnsupportedError(
                        f"forest member of {pair} is "
                        f"{type(rf).__name__}, not a fitted packed forest")
                packed.append(rf.forest_)
            T = packed[0].n_trees
            if any(f.n_trees != T for f in packed):
                raise BankUnsupportedError("tree counts differ across pairs")
            G = len(packed)
            n_max = max(f.feat.shape[1] for f in packed)
            feat = np.full((G, T, n_max), -1, np.int32)
            thr = np.zeros((G, T, n_max), np.float64)
            left = np.zeros((G, T, n_max), np.int32)
            right = np.zeros((G, T, n_max), np.int32)
            value = np.zeros((G, T, n_max), np.float64)
            for g, f in enumerate(packed):
                n = f.feat.shape[1]
                feat[g, :, :n] = f.feat
                thr[g, :, :n] = f.thr
                left[g, :, :n] = f.left
                right[g, :, :n] = f.right
                value[g, :, :n] = f.value
            depth = np.array([f.depth for f in packed], np.int64)
            forest = {k: torch.from_numpy(v).to(dev) for k, v in
                      (("feat", feat), ("thr", thr), ("left", left),
                       ("right", right), ("value", value), ("depth", depth))}
        if "dnn" in members:
            heads = []
            for pair in pairs:
                head = profet.cross[pair].models["dnn"]
                if not isinstance(head, DNNRegressor) or head.params is None:
                    raise BankUnsupportedError(
                        f"dnn member of {pair} is {type(head).__name__}, "
                        "not a fitted DNNRegressor")
                heads.append(head)
            try:
                dnn = stack_dnn_heads(heads, dev)
            except (RuntimeError, IndexError, ValueError) as e:
                raise BankUnsupportedError(
                    f"dnn heads do not stack: {e!r}") from e
            if n_features < 0:
                n_features = dnn[1].shape[1]

        devices = tuple(sorted({d for pair in pairs for d in pair}))
        try:
            scalers = profet.scaler_stack(devices)
        except KeyError as e:
            raise BankUnsupportedError(
                f"missing phase-2 scaler for device {e}") from e
        return cls(pairs=pairs, members=members, n_features=n_features,
                   forest=forest, lin_coef=lin_coef, dnn=dnn,
                   devices=devices, scalers=scalers, device=dev)

    # ------------------------------------------------------------------
    # group-axis sharding
    # ------------------------------------------------------------------
    def split(self, groups: Sequence[Sequence[Tuple[str, str]]]
              ) -> Tuple[Optional["ModelBank"], ...]:
        """Slice the bank's group axis into sub-banks, one per entry of
        ``groups`` (a partition of ``self.pairs``, e.g. from
        ``planner.partition_pairs``). Each sub-bank carries only its
        pairs' stacked tensors but the FULL device set and phase-2
        scalers — phase-2 is per-device, not per-pair, so every shard
        can interpolate any row it predicted. Slicing is pure gathering
        (an index tensor on the bank's device for the forest and DNN
        stacks, ``arr[idx]`` for the host arrays), so a sub-bank's answers
        are bit-identical to the full bank's for the same rows on the
        float64 members. Empty groups map to ``None``; pairs the bank
        never trained raise ``BankUnsupportedError``."""
        banks = []
        for part in groups:
            part = tuple(part)
            if not part:
                banks.append(None)
                continue
            missing = [p for p in part if p not in self.gid]
            if missing:
                raise BankUnsupportedError(
                    f"cannot split: pairs not in bank: {missing}")
            idx = np.array([self.gid[p] for p in part], np.int64)
            tidx = torch.from_numpy(idx).to(self.device)
            forest = None
            if self.forest is not None:
                forest = {k: v[tidx] for k, v in self.forest.items()}
            lin_coef = None if self.lin_coef is None else self.lin_coef[idx]
            dnn = None
            if self.dnn is not None:
                params, mu, sd, ys = self.dnn
                dnn = ([{k: v[tidx] for k, v in layer.items()}
                        for layer in params], mu[idx], sd[idx], ys[idx])
            banks.append(ModelBank(
                pairs=part, members=self.members,
                n_features=self.n_features, forest=forest,
                lin_coef=lin_coef, dnn=dnn, devices=self.devices,
                scalers=self.scalers, device=self.device))
        return tuple(banks)

    # ------------------------------------------------------------------
    # wire form (remote shard distribution)
    # ------------------------------------------------------------------
    def to_payload(self) -> dict:
        """The bank as one self-contained wire value: every stacked tensor
        copied off the device into an inline contiguous numpy array, ready
        for the shard worker codecs (``repro_torch.serve.frames``).
        ``device`` names the device the bank was built on; the receiving
        worker places the arrays on its own (:meth:`from_payload`)."""
        return {
            "pairs": self.pairs,
            "members": self.members,
            "n_features": self.n_features,
            "devices": self.devices,
            "scalers": {k: tuple(np.ascontiguousarray(a) for a in v)
                        for k, v in self.scalers.items()},
            "device": str(self.device),
            "forest": (None if self.forest is None else
                       {k: host_array(v) for k, v in self.forest.items()}),
            "lin_coef": (None if self.lin_coef is None
                         else np.ascontiguousarray(self.lin_coef)),
            "dnn": (None if self.dnn is None
                    else ([{k: host_array(v) for k, v in layer.items()}
                           for layer in self.dnn[0]],
                          np.ascontiguousarray(self.dnn[1]),
                          np.ascontiguousarray(self.dnn[2]),
                          np.ascontiguousarray(self.dnn[3]))),
        }

    @classmethod
    def from_payload(cls, d: dict, device="cuda") -> "ModelBank":
        """Rebuild a bank around the decoded wire value, its forest and DNN
        stacks placed on ``device``. The codec hands arrays back as
        read-only views over the received frame body; the host arrays
        (linear coefficients, z-score stats, scalers) stay those views,
        the stacks are copied to ``device``."""
        dev = resolve_device(device)
        pairs = tuple(tuple(p) for p in d["pairs"])
        forest = None
        if d["forest"] is not None:
            forest = {k: device_tensor(v, dev) for k, v in d["forest"].items()}
        dnn = None
        if d["dnn"] is not None:
            params, mu, sd, ys = d["dnn"]
            dnn = ([{k: device_tensor(v, dev) for k, v in layer.items()}
                    for layer in params], np.asarray(mu), np.asarray(sd),
                   np.asarray(ys))
        return cls(pairs=pairs, members=tuple(d["members"]),
                   n_features=int(d["n_features"]), forest=forest,
                   lin_coef=d["lin_coef"], dnn=dnn,
                   devices=tuple(d["devices"]),
                   scalers={k: tuple(v) for k, v in d["scalers"].items()},
                   device=dev)

    # ------------------------------------------------------------------
    # stacked execution
    # ------------------------------------------------------------------
    def execute(self, X: np.ndarray, gids: np.ndarray) -> np.ndarray:
        """Median-ensemble prediction for every row of ``X``, row ``i``
        answered by group ``gids[i]`` — one grouped forest launch plus one
        stacked MLP apply for the whole wave, whatever mix of pairs it
        carries."""
        X = np.ascontiguousarray(X, np.float64)
        gids = np.ascontiguousarray(gids, np.int64)
        if gids.size and (gids.min() < 0 or gids.max() >= self.n_groups):
            raise ValueError(f"group ids must lie in [0, {self.n_groups})")
        preds = []
        if "linear" in self.members:
            design = LinearRegressor._design(X)
            preds.append(LinearRegressor.apply(design, self.lin_coef[gids]))
        if "forest" in self.members:
            f = self.forest
            preds.append(forest_eval.predict_grouped(
                device_tensor(X, self.device),
                device_tensor(gids, self.device), f["feat"], f["thr"],
                f["left"], f["right"], f["value"], f["depth"]).cpu().numpy())
            self.forest_launches += 1
        if "dnn" in self.members:
            preds.append(self._dnn_member(X, gids))
        return np.median(np.stack(preds), axis=0)

    def _dnn_member(self, X: np.ndarray, gids: np.ndarray) -> np.ndarray:
        """One stacked MLP apply: rows scattered into a dense bucketed
        ``(groups, rows, features)`` block, heads gathered on the device."""
        params, mu, sd, ys = self.dnn
        uniq, local = np.unique(gids, return_inverse=True)
        counts = np.bincount(local)
        g_pad = bucket(len(uniq))
        r_pad = bucket(int(counts.max()), DNNRegressor.PREDICT_BUCKET_MIN)
        # per-row slot inside its group's row block
        order = np.argsort(local, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(len(gids), np.int64)
        slot[order] = np.arange(len(gids)) - starts[local[order]]
        # normalized exactly like DNNRegressor.predict: float64 z-score,
        # then one float32 cast
        Xn = ((X - mu[gids]) / sd[gids]).astype(np.float32)
        block = np.zeros((g_pad, r_pad, X.shape[1]), np.float32)
        block[local, slot] = Xn
        gidx = np.zeros(g_pad, np.int64)
        gidx[:len(uniq)] = uniq
        out = mlp_apply_multi(params, torch.from_numpy(gidx).to(self.device),
                              torch.from_numpy(block).to(self.device))
        self.mlp_applies += 1
        return out.cpu().numpy()[local, slot] * ys[gids]

    def interpolate(self, kinds: Sequence[str], dev_ids: np.ndarray,
                    values: np.ndarray, t_min: np.ndarray,
                    t_max: np.ndarray) -> np.ndarray:
        """Vectorized phase-2 over heterogeneous rows: one Horner pass,
        each row using its (device, knob-kind) coefficient row — bitwise
        equal to per-group ``PolyScaler.predict``."""
        n = len(values)
        coef = np.empty((n, self.scalers["batch"][0].shape[1]))
        lo = np.empty(n)
        hi = np.empty(n)
        for kind in ("batch", "pixel"):
            sel = np.array([k == kind for k in kinds])
            if not sel.any():
                continue
            c, l, h = self.scalers[kind]
            coef[sel] = c[dev_ids[sel]]
            lo[sel] = l[dev_ids[sel]]
            hi[sel] = h[dev_ids[sel]]
        x = (np.asarray(values, np.float64) - lo) / (hi - lo)
        r = np.zeros(n)
        for j in range(coef.shape[1]):
            r = r * x + coef[:, j]
        return r * (np.asarray(t_max) - np.asarray(t_min)) + \
            np.asarray(t_min)

    # ------------------------------------------------------------------
    # warm-up
    # ------------------------------------------------------------------
    def warmup(self, max_rows: int = 64) -> float:
        """Make the first live wave after a swap pay no one-off cost: build
        and load the kernel library, run every MLP bucket shape a wave up
        to ``max_rows`` rows can produce, and make one grouped forest
        launch per shape class (all rows in one group; one row in each
        group), which also allocates the fused kernel's tile counters for
        this stream. Returns the wall seconds spent (also kept in
        ``warmup_ms``)."""
        t0 = time.perf_counter()
        dev = self.device
        if "dnn" in self.members and self.n_features > 0:
            params = self.dnn[0]
            g_caps, r_caps = [], []
            g = 1
            while True:
                g_caps.append(min(g, bucket(self.n_groups)))
                if g >= bucket(self.n_groups):
                    break
                g *= 2
            r = DNNRegressor.PREDICT_BUCKET_MIN
            while True:
                r_caps.append(r)
                if r >= bucket(max(max_rows, 1),
                                DNNRegressor.PREDICT_BUCKET_MIN):
                    break
                r *= 2
            for g_pad in sorted(set(g_caps)):
                gidx = torch.zeros(g_pad, dtype=torch.int64, device=dev)
                for r_pad in r_caps:
                    mlp_apply_multi(params, gidx, torch.zeros(
                        (g_pad, r_pad, self.n_features), dtype=torch.float32,
                        device=dev))
        if "forest" in self.members and self.n_features > 0:
            if dev.type == "cuda":
                forest_eval.library()
            f = self.forest
            args = (f["feat"], f["thr"], f["left"], f["right"], f["value"],
                    f["depth"])
            for gid in (torch.zeros(max(max_rows, 1), dtype=torch.int64),
                        torch.arange(self.n_groups, dtype=torch.int64)):
                forest_eval.predict_grouped(
                    torch.zeros((len(gid), self.n_features),
                                dtype=torch.float64, device=dev),
                    gid.to(dev), *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.warmup_ms += 1e3 * dt
        return dt

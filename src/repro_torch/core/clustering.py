"""Feature engineering by operation-name clustering (paper §III-B).

Levenshtein distance over op names -> DxD symmetric matrix -> agglomerative
hierarchical clustering with AVERAGE linkage -> cut the dendrogram at a
maximum height (paper: 6) -> features in one cluster are aggregated by SUM.

No scipy in this environment: Levenshtein and average-linkage HAC are
implemented from scratch (O(D^2 L^2) and O(D^3) — D is ~65 op names, trivial).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# The paper's empirically-best cut is 6.0 — on ITS 65-op TF vocabulary. Our
# measurement plane emits a smaller vocabulary (~31 names, shorter strings),
# where height 6 over-merges (MatMul lands with Relu/Cast/...) and hurts
# held-out-model accuracy. Re-running the paper's own empirical sweep on our
# vocabulary (benchmarks/bench_fig13.py) puts the optimum at ~2.0:
#   MobileNetV2 holdout MAPE: off=28.7  h2=4.9  h6=15.6
DEFAULT_MAX_HEIGHT = 2.0


def levenshtein(a: str, b: str) -> int:
    """Edit distance (insert/delete/replace), vectorized row DP."""
    if a == b:
        return 0
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    bv = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, start=1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (bv != ord(ca))
        # insertion from prev row
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        # deletion needs a left-to-right pass
        for j in range(1, len(b) + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[-1])


def distance_matrix(names: Sequence[str]) -> np.ndarray:
    d = len(names)
    mat = np.zeros((d, d), dtype=np.float64)
    for i in range(d):
        for j in range(i + 1, d):
            mat[i, j] = mat[j, i] = levenshtein(names[i], names[j])
    return mat


@dataclasses.dataclass
class Dendrogram:
    """Merge list in scipy linkage style: rows (a, b, height, size)."""
    merges: np.ndarray          # (D-1, 4)
    names: List[str]

    def cut(self, max_height: float) -> List[List[int]]:
        """Flat clusters: all merges with height <= max_height applied."""
        d = len(self.names)
        parent = list(range(2 * d - 1))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for idx, (a, b, h, _) in enumerate(self.merges):
            if h <= max_height:
                node = d + idx
                parent[find(int(a))] = node
                parent[find(int(b))] = node
        groups: Dict[int, List[int]] = {}
        for leaf in range(d):
            groups.setdefault(find(leaf), []).append(leaf)
        return sorted(groups.values(), key=lambda g: g[0])


def average_linkage(dist: np.ndarray, names: Sequence[str]) -> Dendrogram:
    """UPGMA agglomerative clustering (average linkage, paper's choice)."""
    d = dist.shape[0]
    active = {i: [i] for i in range(d)}     # cluster id -> leaf members
    cur = {i: i for i in range(d)}          # cluster id -> node id
    work = dist.astype(np.float64).copy()
    np.fill_diagonal(work, np.inf)
    # pairwise distances between active clusters, averaged over leaf pairs
    merges = []
    cluster_ids = list(range(d))
    cdist = {(i, j): work[i, j] for i in range(d) for j in range(i + 1, d)}
    next_node = d
    while len(cluster_ids) > 1:
        (i, j), h = min(cdist.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((cur[i], cur[j], h, len(active[i]) + len(active[j])))
        # merge j into i as a new cluster
        new_members = active[i] + active[j]
        for k in cluster_ids:
            if k in (i, j):
                continue
            key_ik = (min(i, k), max(i, k))
            d_new = float(np.mean(dist[np.ix_(new_members, active[k])]))
            cdist[key_ik] = d_new
        cluster_ids.remove(j)
        for k in list(cdist):
            if j in k:
                del cdist[k]
        active[i] = new_members
        cur[i] = next_node
        del active[j], cur[j]
        next_node += 1
    return Dendrogram(merges=np.array(merges, dtype=np.float64),
                      names=list(names))


@dataclasses.dataclass
class FeatureClustering:
    """Fitted op-name clustering: maps raw op-name features to aggregated
    cluster features; unseen op names are routed to the nearest cluster
    (if within max_height) — the paper's ReLU6->ReLU generalization."""
    names: List[str]
    clusters: List[List[int]]
    max_height: float

    @classmethod
    def fit(cls, names: Sequence[str],
            max_height: float = DEFAULT_MAX_HEIGHT) -> "FeatureClustering":
        names = list(names)
        if len(names) <= 1:
            return cls(names=names, clusters=[[0]] if names else [],
                       max_height=max_height)
        dend = average_linkage(distance_matrix(names), names)
        return cls(names=names, clusters=dend.cut(max_height),
                   max_height=max_height)

    @property
    def cluster_names(self) -> List[str]:
        return ["+".join(self.names[i] for i in c) for c in self.clusters]

    def _route_unseen(self, name: str) -> Optional[int]:
        best, best_d = None, np.inf
        for ci, members in enumerate(self.clusters):
            dmean = float(np.mean([levenshtein(name, self.names[i])
                                   for i in members]))
            if dmean < best_d:
                best, best_d = ci, dmean
        return best if best_d <= self.max_height else None

    def _name_index(self) -> Dict[str, int]:
        """op name -> cluster id, built once and cached (transform is the
        inner loop of feature-matrix construction). getattr-guarded so
        instances unpickled from older artifacts still work."""
        index = getattr(self, "_index_cache", None)
        if index is None:
            index = {self.names[i]: ci for ci, c in enumerate(self.clusters)
                     for i in c}
            self._index_cache = index
        return index

    def transform(self, profile: Dict[str, float]) -> np.ndarray:
        """profile: {op_name: aggregated latency} -> cluster feature vector."""
        out = np.zeros(len(self.clusters), dtype=np.float64)
        index = self._name_index()
        unseen = getattr(self, "_unseen_cache", None)
        if unseen is None:
            unseen = self._unseen_cache = {}
        for name, value in profile.items():
            ci = index.get(name)
            if ci is None:
                if name not in unseen:
                    unseen[name] = self._route_unseen(name)
                ci = unseen[name]
            if ci is not None:
                out[ci] += value
        return out

    def transform_many(self, profiles: Sequence[Dict[str, float]]) -> np.ndarray:
        return np.stack([self.transform(p) for p in profiles])


def identity_features(names: Sequence[str]) -> FeatureClustering:
    """Clustering disabled (for the Fig-13 ablation)."""
    names = list(names)
    return FeatureClustering(names=names,
                             clusters=[[i] for i in range(len(names))],
                             max_height=0.0)

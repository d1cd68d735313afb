"""Deterministic synthetic data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only), kept so that
``repro_torch`` imports nothing of ``repro``; only the import paths differ,
and the same ``(seed, index)`` gives the same batch bit for bit.

Goals (matching what a production loader must provide, minus real storage):
  - *Deterministic & seekable*: batch ``i`` is a pure function of
    ``(seed, i)`` so a restarted/elastic job resumes mid-epoch exactly
    (``skip_to`` is O(1), no replaying).
  - *Host-sharded*: each host materializes only its shard of the global
    batch (``host_slice``), the way a multi-pod input pipeline must.
  - *Model-aware*: emits the extra stub-frontend tensors ([vlm] patches,
    [audio] frames) the assigned architectures need.

Token streams are low-entropy Zipf-ish sequences with structure (repeated
n-grams), so a few hundred training steps visibly reduce loss in the
end-to-end example — pure-uniform tokens would leave nothing learnable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def _batch_rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, index + 1]))


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # host sharding: this host owns rows [host_id*per_host, ...)
    num_hosts: int = 1
    host_id: int = 0

    @property
    def per_host(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Seekable synthetic next-token-prediction stream."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self._index = 0
        # A fixed random "phrasebook" of n-grams shared by every batch: makes
        # the stream compressible (learnable) yet stationary.
        rng = _batch_rng(data.seed, -1)
        self.vocab = min(cfg.vocab_size, 32_768)
        self.ngrams = rng.integers(
            0, self.vocab, size=(256, 8), dtype=np.int32)

    # ------------------------------------------------------------------
    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        d, cfg = self.data, self.cfg
        rng = _batch_rng(d.seed, index)
        B, S = d.global_batch, d.seq_len
        # sample n-gram ids Zipf-ishly, then unroll to tokens
        n_slots = S // 8 + 1
        ids = rng.zipf(1.3, size=(B, n_slots)) % len(self.ngrams)
        toks = self.ngrams[ids].reshape(B, -1)[:, :S + 1]
        if toks.shape[1] < S + 1:
            toks = np.pad(toks, ((0, 0), (0, S + 1 - toks.shape[1])))
        lo = d.host_id * d.per_host
        toks = toks[lo:lo + d.per_host]
        out = {"tokens": toks[:, :S].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (d.per_host, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (d.per_host, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        return out

    # ------------------------------------------------------------------
    def skip_to(self, index: int) -> "SyntheticLM":
        """O(1) seek — resume-from-checkpoint lands here."""
        self._index = index
        return self

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._index)
        self._index += 1
        return b

    @property
    def index(self) -> int:
        return self._index


def make_pipeline(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                  seed: int = 0, num_hosts: int = 1, host_id: int = 0
                  ) -> SyntheticLM:
    return SyntheticLM(cfg, DataConfig(seq_len=seq_len,
                                       global_batch=global_batch, seed=seed,
                                       num_hosts=num_hosts, host_id=host_id))

"""The one generator of training traffic: token batches drawn from a seed
by the parameters of a traffic file (``perfbench/traffic/<name>.json``).

A training mix gives ``global_batch`` sequences of ``seq_len`` tokens a
step, cut into ``microbatches``, and the shape of its token stream: a
phrasebook of ``ngrams`` random n-grams of ``ngram_len`` tokens over the
whole vocabulary, drawn once per seed, and each sequence a run of phrases
picked by a Zipf law of exponent ``zipf_a``. So the stream repeats phrases
as text does and every sequence differs. Batch ``i`` is a function of
``(seed, i)`` alone. The program's synthetic pipeline
(``repro_torch.data.pipeline``) draws its stream the same way over at most
32,768 ids; the benchmark draws its own, so that the program and the
reference get the same batches from it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), index + 1]))


class TokenBatches:
    """Seeded next-token batches, ``{"tokens", "labels"}`` int32 (B, S) in
    numpy; an iterator from batch 0 on, and :meth:`batch_at` for any."""

    def __init__(self, traffic: dict, vocab_size: int, seed: int):
        self.t = traffic
        self.seed = seed
        self.phrases = _rng(seed, -1).integers(
            0, vocab_size, size=(traffic["ngrams"], traffic["ngram_len"]),
            dtype=np.int32)
        self.index = 0

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        B, S = self.t["global_batch"], self.t["seq_len"]
        n = self.phrases.shape[1]
        rng = _rng(self.seed, index)
        ids = rng.zipf(self.t["zipf_a"], size=(B, S // n + 1)) % len(self.phrases)
        toks = self.phrases[ids].reshape(B, -1)[:, :S + 1]
        return {"tokens": np.ascontiguousarray(toks[:, :S]),
                "labels": np.ascontiguousarray(toks[:, 1:])}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.index)
        self.index += 1
        return batch


def rows_differ(batch: Dict[str, np.ndarray]) -> bool:
    """Whether no two sequences of the batch are the same."""
    toks = batch["tokens"]
    return len(np.unique(toks, axis=0)) == len(toks)

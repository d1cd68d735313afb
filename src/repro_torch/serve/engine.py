"""Batched LM serving engine: a slot-based scheduler over the decode step,
ported from ``repro.serve.engine``.

  - A fixed pool of ``batch_slots`` decode slots shares one decode step:
    the cache is (layers, B, Smax, ...) and every call decodes one token
    for all B slots.
  - Prompts are prefilled token by token through the same decode path
    (teacher forcing), as in the reference: the engine runs no prefill
    kernel.
  - Greedy sampling over the padded vocabulary; per-slot stop on EOS or
    ``max_new_tokens``.

The model's floating parameters are cast to bfloat16 (a copy; the
caller's model is left as it is). PyTorch runs the step eagerly on the
model's device; the reference's ``jax.jit`` and mesh have no counterpart
on one card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_finish: float = 0.0


@dataclasses.dataclass
class EngineStats:
    waves: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    generated_tokens: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0


class Engine:
    """Batched engine with two schedulers:

    - ``continuous`` (default): inflight batching. Every step decodes ONE
      token for all slots with PER-SLOT cache positions (a (B,) ``cur_len``);
      finished slots are refilled at once, and prefill tokens of new
      requests ride in the same batched step as other slots' decode tokens.
    - ``wave``: aligned static batching (admit up to B requests, left-pad
      to a common start, run to completion), kept for comparison.
    """

    def __init__(self, cfg: ModelConfig, model, *, batch_slots: int = 4,
                 max_len: int = 512, mode: str = "continuous"):
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown engine mode {mode!r}")
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.mode = mode
        self.model = M.cast(model, cfg, torch.bfloat16)
        self.device = next(self.model.parameters()).device
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()
        self._uid = 0

    def _decode(self, cache, toks: np.ndarray, cur):
        """One decode step: the greedy next token of every slot (host
        numpy) and the new cache."""
        logits, cache = M.decode_step(
            self.model, self.cfg, cache,
            torch.as_tensor(toks, dtype=torch.int32, device=self.device),
            torch.as_tensor(cur, dtype=torch.int32, device=self.device))
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt.cpu().numpy(), cache

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        req = Request(uid=self._uid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      t_submit=time.time())
        self._uid += 1
        self.queue.append(req)
        return req

    # ------------------------------------------------------------------
    def _run_wave(self, wave: List[Request]) -> None:
        """Serve up to ``batch_slots`` requests through one shared cache."""
        B = self.batch_slots
        max_prompt = max(len(r.prompt) for r in wave)
        budget = max(r.max_new_tokens for r in wave)
        need = max_prompt + budget + 1
        if need > self.max_len:
            raise ValueError(f"a wave needs {need} positions; max_len is "
                             f"{self.max_len}")

        cache = M.init_cache(self.cfg, B, self.max_len, device=self.device)
        # left-pad prompts to a common length so every slot shares cur_len
        toks = np.zeros((B, max_prompt), np.int32)
        for i, r in enumerate(wave):
            toks[i, max_prompt - len(r.prompt):] = r.prompt
        # prefill through the decode path (teacher forcing)
        last = None
        for t in range(max_prompt):
            last, cache = self._decode(cache, toks[:, t:t + 1], t)
            self.stats.prefill_tokens += len(wave)
            self.stats.decode_steps += 1  # one model invocation
        # decode
        cur = last
        active = np.array([not r.done for r in wave] +
                          [False] * (B - len(wave)))
        for step in range(budget):
            for i, r in enumerate(wave):
                if active[i]:
                    tok = int(cur[i])
                    r.output.append(tok)
                    self.stats.generated_tokens += 1
                    if ((r.eos_id is not None and tok == r.eos_id)
                            or len(r.output) >= r.max_new_tokens):
                        active[i] = False
                        r.done = True
                        r.t_finish = time.time()
            if not active.any():
                break
            cur, cache = self._decode(cache, cur[:, None], max_prompt + step)
            self.stats.decode_steps += 1
        for r in wave:
            if not r.done:
                r.done = True
                r.t_finish = time.time()

    # ------------------------------------------------------------------
    @staticmethod
    def _reset_slot(cache, slot: int) -> None:
        """Zero one slot's state in every cache tensor, in place (the batch
        is dim 1 of each). The attention mask hides stale KV, but the
        recurrent family carries cumulative state that MUST be cleared when
        a slot is reassigned."""
        for t in cache.values():
            t[:, slot].zero_()

    def _run_continuous(self) -> None:
        """Inflight batching: per-slot positions, immediate slot refill."""
        B = self.batch_slots
        cache = M.init_cache(self.cfg, B, self.max_len, device=self.device)
        slots: List[Optional[Request]] = [None] * B
        phase = ["idle"] * B          # idle | prefill | decode
        ppos = [0] * B                # next prompt token to feed
        cur_lens = np.zeros(B, np.int32)
        feed = np.zeros(B, np.int32)

        while self.queue or any(s is not None for s in slots):
            # admit new requests into idle slots
            for i in range(B):
                if slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    if len(req.prompt) + req.max_new_tokens > self.max_len:
                        raise ValueError(
                            f"request {req.uid} needs "
                            f"{len(req.prompt) + req.max_new_tokens} "
                            f"positions; max_len is {self.max_len}")
                    slots[i] = req
                    phase[i] = "prefill"
                    ppos[i] = 0
                    cur_lens[i] = 0
                    self._reset_slot(cache, i)
            # choose this step's input token per slot
            for i, r in enumerate(slots):
                if r is None:
                    feed[i] = 0
                elif phase[i] == "prefill":
                    feed[i] = r.prompt[ppos[i]]
                    self.stats.prefill_tokens += 1
                else:
                    feed[i] = r.output[-1]
            nxt, cache = self._decode(cache, feed[:, None], cur_lens)
            self.stats.decode_steps += 1
            # advance per-slot state machines
            for i, r in enumerate(slots):
                if r is None:
                    continue
                cur_lens[i] += 1
                if phase[i] == "prefill":
                    ppos[i] += 1
                    if ppos[i] == len(r.prompt):
                        phase[i] = "decode"
                        r.output.append(int(nxt[i]))
                        self.stats.generated_tokens += 1
                else:
                    r.output.append(int(nxt[i]))
                    self.stats.generated_tokens += 1
                if phase[i] == "decode" and (
                        len(r.output) >= r.max_new_tokens
                        or (r.eos_id is not None
                            and r.output[-1] == r.eos_id)):
                    r.output = r.output[:r.max_new_tokens]
                    r.done = True
                    r.t_finish = time.time()
                    self.finished.append(r)
                    slots[i] = None
                    phase[i] = "idle"

    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Drain the queue; returns finished requests in completion order."""
        t0 = time.time()
        if self.mode == "continuous":
            self._run_continuous()
        else:
            while self.queue:
                wave = self.queue[:self.batch_slots]
                self.queue = self.queue[self.batch_slots:]
                self._run_wave(wave)
                self.stats.waves += 1
                self.finished.extend(wave)
        self.stats.wall_s += time.time() - t0
        return self.finished

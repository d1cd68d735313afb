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
  - The vlm's image ``context`` and the audio family's ``enc_out`` stay
    the zeros ``init_cache`` makes, as in the reference (nothing in the
    serving path fills them).

The model's floating parameters are cast to bfloat16 (a copy; the
caller's model is left as it is). PyTorch runs the step eagerly on the
model's device; the reference's ``jax.jit`` has no counterpart.

On a mesh (``mesh=``, a ``DeviceMesh`` over a process group of one rank
per device, ``repro_torch.launch.mesh``) every rank builds the same
engine, takes the same ``submit``s and runs the same scheduler; ``run()``
returns the same requests, tokens and stats on every rank. The decode
step (``launch.steps.make_decode_step``) runs inside
``sharding.use_mesh`` on arguments placed by ``launch.steps.
place_decode_args``, the dry-run's placement: the parameters by their
logical axes, the cache's slots over the data axes and its sequence over
``model`` (the reference's ``cache_axes``), the tokens' slots over the
data axes and ``cur_len`` replicated. The next tokens are the step's
last-position argmax over the gathered vocabulary, gathered whole over
the slots before they reach the host. A slot is reset on the rank that
holds its row, on that rank's shard.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
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
                 max_len: int = 512, mesh=None, mode: str = "continuous"):
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown engine mode {mode!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.mode = mode
        self.model = M.cast(model, cfg, torch.bfloat16)
        self._batch_dims = M.cache_batch_dims(cfg)
        if mesh is None:
            self.device = next(self.model.parameters()).device
        else:
            self.device = resolve_device(mesh.device_type)
            self.model, _ = ST.place_model(cfg, mesh, self.model)
            self._step = ST.make_decode_step(cfg)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()
        self._uid = 0

    def _decode(self, cache, toks: np.ndarray, cur):
        """One decode step: the greedy next token of every slot (host
        numpy) and the new cache."""
        toks = torch.as_tensor(toks, dtype=torch.int32, device=self.device)
        cur = torch.as_tensor(cur, dtype=torch.int32, device=self.device)
        if self.mesh is None:
            logits, cache = M.decode_step(self.model, self.cfg, cache, toks,
                                          cur)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return nxt.cpu().numpy(), cache
        with SH.use_mesh(self.mesh), torch.no_grad():
            args, _ = ST.place_decode_args(self.cfg, self.mesh, self.model,
                                           cache, toks, cur)
            nxt, cache = self._step(*args)
            nxt = SH.full(nxt)[:, 0]
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
    def _reset_slot(self, cache, slot: int) -> None:
        """Zero one slot's state in every cache tensor, in place, along that
        tensor's own batch dim (``M.cache_batch_dims``: dim 1 of the stacked
        per-layer caches, dim 0 of the vlm ``context`` and the audio
        ``enc_out``). The attention mask hides stale KV, but the recurrent
        families carry cumulative state that MUST be cleared when a slot is
        reassigned. On a mesh only the ranks that hold the slot's row zero
        it, in their own shard (``sharding.local_index``): no collective,
        and no copy that ``select`` on a ``DTensor`` could hand back."""
        with torch.no_grad():
            for name, t in cache.items():
                d = self._batch_dims[name]
                i = SH.local_index(t, d, slot)
                if i is not None:
                    SH.local(t).select(d, i).zero_()

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

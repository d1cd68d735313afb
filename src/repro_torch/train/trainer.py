"""Trainer: the train loop with gradient accumulation, checkpointing, fault
tolerance hooks and straggler monitoring, ported from
``repro.train.trainer``.

The model's float32 parameters are drawn from a ``torch.Generator``
seeded with ``tc.seed`` on ``device`` (``models.model.init``; not
``jax.random``'s numbers), made trainable, and updated in place with the
optimizer state. The device defaults to ``cuda``: there the blocks run the
flash-attention / SSD-scan kernels and their gradients come through the
kernels' ``autograd.Function``s; asking for it without CUDA raises.
Batches come from the data pipeline as numpy and are moved to the device
per step.

``mesh=None`` trains on one device. With a ``DeviceMesh``
(``launch.mesh.make_mesh``; every rank of the process group builds its
own ``Trainer``) the parameters and both Adam moments become ``DTensor``s
placed by the logical-axis rules (``distributed.sharding.
tree_param_shardings`` of ``models.model.param_axes``, the reference's
``trainer.py:114-135``): every rank draws the whole model from the same
seed and keeps its shards. Each rank builds the reference's *global*
batch from the same pipeline and keeps its rows of it (``ACT_RULES
["batch"]``), so the token stream is the reference's. The step runs
inside ``sharding.use_mesh``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as data_pipeline
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainConfig:
    seq_len: int = 256
    global_batch: int = 8
    microbatches: int = 1           # gradient accumulation factor
    num_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    seed: int = 0
    straggler_slack: float = 3.0    # x median step time -> flagged


class StragglerMonitor:
    """EWMA step-time tracker. On real pods this watches per-host heartbeat
    gaps; here it watches wall-clock per step. A step slower than
    ``slack x median`` is flagged — the trainer records the event and (in a
    multi-host deployment) the launcher would rebalance/evict that host."""

    def __init__(self, slack: float = 3.0):
        self.slack = slack
        self.times = []
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 5:
            med = float(np.median(self.times[-50:]))
            if dt > self.slack * med:
                self.flagged.append((step, dt, med))
                return True
        return False


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 hp: Optional[OPT.OptHParams] = None, mesh=None,
                 data: Optional[Iterator] = None, *, device="cuda"):
        self.cfg, self.tc = cfg, tc
        self.mesh = mesh
        self.device = resolve_device(device)
        self.hp = hp or OPT.OptHParams(warmup_steps=10,
                                       decay_steps=max(tc.num_steps, 2))
        self.data = data or data_pipeline.make_pipeline(
            cfg, seq_len=tc.seq_len, global_batch=tc.global_batch,
            seed=tc.seed)
        self.monitor = StragglerMonitor(tc.straggler_slack)
        self.step = 0
        self.history: list = []

        self.model = M.init(cfg, seed=tc.seed, device=self.device)
        self.axes = M.param_axes(self.model)
        if mesh is not None:
            SH.validate_axes(self.params, self.axes)
            self.shardings = SH.tree_param_shardings(
                self.axes, mesh, {k: p.shape for k, p in self.params.items()})
            SH.distribute_params(self.model, mesh, self.shardings)
        self.model.requires_grad_(True)
        self.opt_state = OPT.init_state(self.params, self.hp)
        self._step_fn = ST.make_train_step(cfg, self.hp, tc.microbatches)

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        """The model's parameters by name (``model.named_parameters()``)."""
        return dict(self.model.named_parameters())

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict[str, np.ndarray]):
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        axes = {k: ("batch",) + (None,) * (v.dim() - 1)
                for k, v in out.items()}
        return SH.distribute_tree(out, self.mesh, SH.tree_act_shardings(
            axes, self.mesh, {k: v.shape for k, v in out.items()}))

    def train_one(self, batch=None) -> Dict[str, float]:
        """One optimizer step on ``batch`` (by default the data's next):
        its metrics as floats and ``step_time_s``, the monotonic clock's
        seconds from the batch's copy to the device to the metrics on the
        host. The step is the span ``train_step`` over ``train_step/data``
        (the batch from its source and to the device), the step function's
        spans (``launch.steps.make_train_step``) and
        ``train_step/readback`` (the metrics stacked and copied to the host
        at once: the step's one wait for the device)."""
        with spans.span("train_step"), SH.use_mesh(self.mesh):
            with spans.span("train_step/data"):
                if batch is None:
                    batch = next(self.data)
                t0 = time.perf_counter()
                batch = self._device_batch(batch)
            _, self.opt_state, metrics = self._step_fn(
                self.model, self.opt_state, batch)
            with spans.span("train_step/readback"):
                values = torch.stack(list(metrics.values())).tolist()
        metrics = dict(zip(metrics, values))
        self.step += 1
        dt = time.perf_counter() - t0
        self.monitor.observe(self.step, dt)
        metrics["step_time_s"] = dt
        self.history.append({"step": self.step, **metrics})
        return metrics

    # ------------------------------------------------------------------
    def _tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "data_index": np.int32(getattr(self.data, "index", 0))}

    def save(self) -> None:
        if not self.tc.ckpt_dir:
            return
        CKPT.save(self.tc.ckpt_dir, self.step, self._tree(),
                  keep=self.tc.ckpt_keep)

    def maybe_restore(self) -> bool:
        """Resume from the newest checkpoint if one exists."""
        if not self.tc.ckpt_dir:
            return False
        placements = None
        if self.mesh is not None:   # the elastic re-mesh: this trainer's
            placements = {f"{part}/{k}": pl        # own placements
                          for k, pl in self.shardings.items()
                          for part in ("params", "opt/m", "opt/v")}
        step, tree = CKPT.restore_latest(self.tc.ckpt_dir, self._tree(),
                                         device=self.device, mesh=self.mesh,
                                         placements=placements)
        if step is None:
            return False
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(tree["params"][name])
        self.opt_state = tree["opt"]
        self.step = step
        if hasattr(self.data, "skip_to"):
            self.data.skip_to(int(tree["data_index"]))
        return True

    # ------------------------------------------------------------------
    def run(self, num_steps: Optional[int] = None,
            on_step: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, float]:
        num_steps = num_steps or self.tc.num_steps
        last = {}
        while self.step < num_steps:
            last = self.train_one()
            if on_step:
                on_step(self.step, last)
            if self.tc.log_every and self.step % self.tc.log_every == 0:
                print(f"step {self.step:5d} loss {last['loss']:.4f} "
                      f"lr {last['lr']:.2e} gnorm {last['grad_norm']:.3f} "
                      f"({last['step_time_s']*1e3:.0f} ms)", flush=True)
            if (self.tc.ckpt_dir and self.tc.ckpt_every
                    and self.step % self.tc.ckpt_every == 0):
                self.save()
        if self.tc.ckpt_dir:
            self.save()
        return last

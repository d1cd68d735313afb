"""Fault tolerance: preemption injection, recovery loop, elastic re-mesh.

Real multi-pod failure modes and their handling here:
  - *Preemption / node loss*: :class:`FailureInjector` raises
    :class:`SimulatedPreemption` at scheduled steps; :func:`run_with_recovery`
    catches it, rebuilds the trainer from the newest atomic checkpoint and
    continues — the loop a production launcher (GKE/Borg restart policy)
    performs across real job restarts.
  - *Elastic scaling*: the rebuild callback may hand back a trainer on a
    DIFFERENT mesh or device (e.g. 4 ranks -> 2 after losing a host).
    Checkpoints are host numpy, so they restore onto any mesh or device
    (`checkpoint.restore(..., mesh=..., placements=...)`, or the placements
    of the new trainer's own parameters).
  - *Stragglers*: `trainer.monitor` flags slow steps; the recovery loop
    surfaces the flags so an external scheduler could evict the slow host.

The recovery loop never re-runs a completed step: the data pipeline index is
checkpointed with the params, so the token stream continues exactly where the
failed attempt's last checkpoint left it (at-most-once per batch between
checkpoints, the standard large-scale contract).

The port's copy of ``repro.train.fault_tolerance``; only the imports and
the elastic note above differ.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.train.trainer import Trainer


class SimulatedPreemption(RuntimeError):
    pass


class FailureInjector:
    """Raises at each step in ``schedule`` (once per scheduled step)."""

    def __init__(self, schedule: Sequence[int]):
        self.schedule = set(schedule)
        self.fired: List[int] = []

    def check(self, step: int) -> None:
        if step in self.schedule:
            self.schedule.discard(step)
            self.fired.append(step)
            raise SimulatedPreemption(f"injected failure at step {step}")


@dataclasses.dataclass
class RecoveryReport:
    restarts: int
    completed_steps: int
    final_metrics: Dict[str, float]
    straggler_flags: List
    preemptions: List[int]


def run_with_recovery(make_trainer: Callable[[int], Trainer],
                      num_steps: int,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 10) -> RecoveryReport:
    """Drive training to ``num_steps`` across failures.

    ``make_trainer(attempt)`` builds a fresh trainer per attempt (attempt 0 is
    the initial launch); it may change the mesh between attempts (elastic).
    The trainer's ckpt_dir must be set for recovery to make progress.
    """
    restarts = 0
    preemptions: List[int] = []
    flags: List = []
    last: Dict[str, float] = {}
    while True:
        trainer = make_trainer(restarts)
        trainer.maybe_restore()

        def on_step(step: int, metrics: Dict) -> None:
            if injector is not None:
                injector.check(step)

        try:
            last = trainer.run(num_steps, on_step=on_step)
            flags.extend(trainer.monitor.flagged)
            return RecoveryReport(restarts=restarts,
                                  completed_steps=trainer.step,
                                  final_metrics=last,
                                  straggler_flags=flags,
                                  preemptions=preemptions)
        except SimulatedPreemption:
            preemptions.append(trainer.step)
            flags.extend(trainer.monitor.flagged)
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts")

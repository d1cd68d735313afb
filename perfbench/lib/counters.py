"""The program's own counters over a run's traced steps, for the per-layer
readers: ``repro_torch.spans.drain()``, which holds each span's host wall
time and calls (``<span>:host_ns``, ``<span>:calls``) and the program's
counters (``moe/kept``, ``moe/choices``, ``moe/slots``).

The program counts only while a profiler records, which in a run is the
traced steps alone, so the first reader to ask drains the counters once
and keeps them on the run's ``Trace`` as ``counters``. A program without
``repro_torch.spans`` has none (``{}``). A trace in which the device ran
nothing was not taken on the card and gives None, as the device's metrics
do there."""
from __future__ import annotations

from typing import Dict, Optional


def of(run) -> Optional[Dict[str, int]]:
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    if not hasattr(t, "counters"):
        try:
            from repro_torch import spans
        except ImportError:             # a program that has no spans
            t.counters = {}
        else:
            t.counters = spans.drain()
    return t.counters

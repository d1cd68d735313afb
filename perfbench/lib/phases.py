"""The device's idle time, the host's wall time and its kernel launches by
phase of the program's train step, from a profiler's trace.

The program marks each optimizer step with the span ``train_step`` and its
phases under it (``repro_torch.spans``): ``train_step/data``,
``train_step/forward``, ``train_step/backward``, ``train_step/optimizer``,
``train_step/readback``. Time is cut at every such span's ends and each
piece goes to the innermost span covering it, whatever thread the work
under that span ran on; pieces that no span covers go to ``(outside)``.

- ``idle_s``: each idle gap of the device (the gaps of
  ``lib/tracing.capture``: the traced interval less the union of the
  device's kernels, copies and fills) is split by overlap among those
  pieces, so the phases' ``idle_s`` and ``(outside)``'s add up to the
  gaps' total.
- ``launches``: each kernel launch on the host (a ``cudaLaunchKernel*`` or
  ``cuLaunchKernel*`` runtime event) counts under the piece its start falls
  in; the backward's launches, made on autograd's own thread, land in
  ``train_step/backward``.
- ``host_s`` and ``calls``: each span's summed wall time and count.

:func:`split_idle` and :func:`count_launches` are pure, on hand-made
intervals; :func:`of_events` reads ``prof.events()``. ``tools/
trace_phases.py`` prints them for a cell on the card.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

from perfbench.lib.tracing import _merge

PHASES = ("train_step", "train_step/data", "train_step/forward",
          "train_step/backward", "train_step/optimizer",
          "train_step/readback")
OUTSIDE = "(outside)"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")

Span = Tuple[str, float, float]               # (name, start, end)


def pieces(spans: Sequence[Span]) -> List[list]:
    """Time cut at every span's ends: ``[[start, end, name], ...]`` in
    order, each piece named by the innermost (shortest) span covering it;
    time no span covers is left out."""
    events = sorted((a, b, name) for name, a, b in spans if b > a)
    points = sorted({x for a, b, _ in events for x in (a, b)})
    out, active, i = [], [], 0
    for lo, hi in zip(points, points[1:]):
        while i < len(events) and events[i][0] <= lo:
            active.append(events[i])
            i += 1
        active = [e for e in active if e[1] > lo]
        if not active:
            continue
        name = min(active, key=lambda e: e[1] - e[0])[2]
        if out and out[-1][2] == name and out[-1][1] == lo:
            out[-1][1] = hi
        else:
            out.append([lo, hi, name])
    return out


def split_idle(gaps: Sequence[Tuple[float, float]],
               spans: Sequence[Span]) -> Dict[str, float]:
    """The gaps' length by the innermost span over each stretch of them,
    ``OUTSIDE`` for the stretches no span covers (the input's unit)."""
    segs = pieces(spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in sorted(gaps):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi, name = segs[k]
            overlap = min(b, hi) - max(a, lo)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
                covered += overlap
            k += 1
        if b - a - covered > 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
    return out


def count_launches(starts: Sequence[float],
                   spans: Sequence[Span]) -> Dict[str, int]:
    """Launches by the innermost span their start falls in (``OUTSIDE``
    for none)."""
    segs = pieces(spans)
    lows = [s[0] for s in segs]
    out: Dict[str, int] = {}
    for t in starts:
        i = bisect.bisect_right(lows, t) - 1
        name = segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE
        out[name] = out.get(name, 0) + 1
    return out


def table(gaps, spans: Sequence[Span], starts) -> Dict[str, dict]:
    """``{phase: {"host_s", "idle_s", "launches", "calls"}}`` for each of
    :data:`PHASES` found among ``spans`` and for ``OUTSIDE`` (times in
    microseconds in, seconds out, as the profiler's events give them)."""
    spans = [s for s in spans if s[0] in PHASES]
    idle = split_idle(gaps, spans)
    launches = count_launches(starts, spans)
    out = {}
    for name in PHASES + (OUTSIDE,):
        mine = [b - a for n, a, b in spans if n == name]
        if not mine and name != OUTSIDE:
            continue
        out[name] = {"host_s": sum(mine) / 1e6,
                     "idle_s": idle.get(name, 0.0) / 1e6,
                     "launches": launches.get(name, 0), "calls": len(mine)}
    return out


def of_events(events) -> dict:
    """``prof.events()`` of a ``torch.profiler`` session over whole train
    steps: the device's busy and idle seconds over the traced interval (as
    ``lib/tracing.capture`` takes them) and the phases' :func:`table`."""
    from torch.autograd import DeviceType
    annotations = {e.name for e in events
                   if e.device_type == DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)}
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in annotations:
                continue            # a range's copy on the device's timeline
            device.append((a, b))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, a, b))
    merged = _merge(device)
    start = min([a for _, a, _ in host] + [m[0] for m in merged[:1]],
                default=0.0)
    end = max([b for _, _, b in host] + [m[1] for m in merged[-1:]],
              default=0.0)
    edges = [start] + [x for m in merged for x in m] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    starts = [a for name, a, _ in host if name.startswith(LAUNCHES)]
    return {"traced_s": (end - start) / 1e6,
            "busy_s": sum(b - a for a, b in merged) / 1e6,
            "idle_s": sum(b - a for a, b in gaps) / 1e6,
            "phases": table(gaps, host, starts)}

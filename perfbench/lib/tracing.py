"""A few steps under ``torch.profiler``, reduced to what the per-layer
readers and the result's breakdown need: the device's busy time (the
union of the intervals in which a kernel, copy or fill ran), the device
time under each host span (a ``record_function`` range, an autograd node,
a registered op: the kernels it launched and its children launched), and
the idle gaps by what the host was doing when they fell.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass
class Trace:
    window_s: float                 # wall time of the traced steps
    busy_s: float                   # union of device activity
    steps: int                      # optimizer steps traced
    spans: Dict[str, Tuple[float, int]]   # host span -> (device s, calls)
    device_ops: List[list]          # [[kernel, s], ...] most time first
    idle_gaps: List[list]           # [[host span, s], ...] longest first


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host event that spans
    each gap's middle."""
    mids = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    sorted_mids = [mids[i] for i in order]
    best = [None] * len(gaps)               # (duration, name)
    for name, a, b in host:
        lo = bisect.bisect_left(sorted_mids, a)
        hi = bisect.bisect_right(sorted_mids, b)
        for j in range(lo, hi):
            i = order[j]
            if best[i] is None or b - a < best[i][0]:
                best[i] = (b - a, name)
    out: Dict[str, float] = {}
    for (a, b), lab in zip(gaps, best):
        key = lab[1] if lab else "(no host event)"
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def capture(torch, run: Callable[[], None], steps: int) -> Trace:
    """``run()`` (``steps`` optimizer steps) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    annotations = {e.name for e in events
                   if e.device_type == DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)}
    device, host, per_kernel = [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in annotations:
                continue            # a range's copy on the device's timeline
            device.append((a, b))
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (b - a) / 1e6
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, a, b))
    merged = _merge(device)
    busy = sum(b - a for a, b in merged) / 1e6
    start = min([a for _, a, _ in host] + [m[0] for m in merged[:1]],
                default=0.0)
    end = max([b for _, _, b in host] + [m[1] for m in merged[-1:]],
              default=0.0)
    edges = [start] + [x for m in merged for x in m] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    by_host = _label_gaps(gaps, host)
    spans = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            spans[e.key] = (e.device_time_total / 1e6, e.count)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=wall, busy_s=busy, steps=steps, spans=spans,
                 device_ops=[[k[:160], v] for k, v in top],
                 idle_gaps=[[k[:160], v] for k, v in gaps_top])

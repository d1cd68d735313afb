"""The program's own trace: named spans and counters, on only while a
``torch.profiler`` session records.

- :func:`span` is a ``torch.profiler.record_function`` range, so the
  program's spans sit in the profiler's trace on the same clock as the
  device's kernels and copies. While a profiler records, a span also adds
  its host wall time and one call to the counters ``<name>:host_ns`` and
  ``<name>:calls``; otherwise it costs what ``record_function`` costs.
- :func:`count` adds a device tensor or a host int to a named counter, and
  with no profiler recording does nothing: no kernel, no allocation, no
  synchronise.
- :func:`drain` returns every counter as ``{name: int}``, with one
  synchronise, and zeroes them.

The counters are the process's, as the profiler's session is, so an
operator reads them by running steps under ``torch.profiler`` and calling
:func:`drain` after it.

Spans of the train step, once per optimizer step under ``train_step``
(``train/trainer.py``, ``launch/steps.py``): ``train_step/data`` (the
batch from its source and its copy to the device), ``train_step/forward``
and ``train_step/backward`` (per microbatch; the backward's device work
runs on autograd's own thread and is timed on its autograd nodes, the span
holds the host's wall time until it returns), ``train_step/optimizer`` and
``train_step/readback`` (the metrics to the host: the step's one wait for
the device). Inside the models: ``moe/route``, ``moe/experts`` (a share's
experts and combine; backward ``MoEExpertsBackward``), ``moe/shared``,
``attention/local``, ``rglru/scan``. Counters of the MoE dispatch
(``models/moe.py``, forward only): ``moe/kept`` (choices that found a
slot), ``moe/choices`` (G·S·k) and ``moe/slots`` (G·E·C); for a layer
holding a share of the experts ``moe/held_choices`` (choices routed to a
held expert), ``moe/held_kept`` (those that found a slot) and
``moe/held_slots`` (G·held·C). Counters of the SSD scan's backward
(``kernels/ssd_scan.py``): ``ssd/backward_calls`` (every backward of
``SSDScan``) and ``ssd/backward_kernel_calls`` (each launch of the
backward kernel). Counters of the norms: ``norm/rows`` (the rows of every
forward call of ``models/layers.rms_norm``, this rank's) and
``norm/kernel_rows`` (the rows of each launch of the norm's forward
kernel, ``kernels/rms_norm.py``). Counters of the selective scan
(``kernels/selective_scan.py``): ``selective_scan/calls`` (every forward
call and every backward of ``SelectiveScan``) and
``selective_scan/kernel_calls`` (each launch of its forward or backward
kernel); its device time sits on the op ``repro_torch::selective_scan`` and
the node ``SelectiveScanBackward``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.profiler import record_function

_lock = threading.Lock()
_host: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}


def enabled() -> bool:
    """True exactly while a profiler session records."""
    return torch.autograd._profiler_enabled()


def _add(name: str, value: int) -> None:
    with _lock:
        _host[name] = _host.get(name, 0) + value


@contextlib.contextmanager
def _timed(name: str):
    with record_function(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            _add(f"{name}:host_ns", time.perf_counter_ns() - t0)
            _add(f"{name}:calls", 1)


def span(name: str):
    """A profiler range named ``name`` (use it as ``with span(name):``)."""
    return _timed(name) if enabled() else record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` (a device tensor, summed on its device, or an int) to
    the counter ``name`` while a profiler records."""
    if not enabled():
        return
    if not isinstance(value, torch.Tensor):
        _add(name, int(value))
        return
    value = value.detach().to(torch.int64)
    with _lock:
        acc = _device.get(name)
        _device[name] = value if acc is None else acc + value


def drain() -> Dict[str, int]:
    """Every counter as ``{name: int}``, zeroed after: the device's
    counters come to the host in one copy (a synchronise) per device."""
    with _lock:
        out, device = dict(_host), dict(_device)
        _host.clear()
        _device.clear()
    by_device: Dict[torch.device, list] = {}
    for name, t in device.items():
        by_device.setdefault(t.device, []).append(name)
    for names in by_device.values():
        values = torch.stack([device[n].reshape(()) for n in names]).tolist()
        for n, v in zip(names, values):
            out[n] = out.get(n, 0) + v
    return out

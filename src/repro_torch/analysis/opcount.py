"""Per-device cost of a torch step, counted over the aten ops it dispatches:
FLOPs, HBM bytes and collective bytes, per op name.

Replaces ``repro.analysis.hlo`` (the reference's walk over the compiled
HLO text) for the port, which runs eagerly: :class:`OpCounter` is a
``TorchDispatchMode`` that sees each op the step dispatches, on real
tensors or under ``FakeTensorMode`` (the dry-run's trace, which allocates
nothing), and returns the reference's :class:`CostSummary`.

What each op counts, per device:

- Under a mesh the counter declines every op on ``DTensor``s (it returns
  ``NotImplemented``, so DTensor runs first) and counts the local ops and
  collectives DTensor issues for them, on this rank's shards. So every
  count is per device, as the reference's SPMD module is, whether the op
  ran on a ``DTensor`` or on the local tensors of a
  ``distributed.sharding.shard_local`` region (where the kernels run).
  The ops DTensor runs on global-shape fake tensors to learn an output's
  shape (its sharding propagation) are not counted.
- FLOPs: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions) from ``torch.utils.flop_counter``'s formulas; the kernel
  ops (``repro_torch::flash_attention``, ``repro_torch::ssd_scan``,
  ``repro_torch::ssd_scan_backward``, ``repro_torch::adamw_sumsq``,
  ``repro_torch::adamw_update``, ``repro_torch::rms_norm``,
  ``repro_torch::rms_norm_backward``, ``repro_torch::selective_scan``,
  ``repro_torch::selective_scan_backward``) their modules' work functions
  (:data:`KERNEL_WORK`); :data:`MOVES` (copies,
  casts, fills, concatenation) none; every other op 1 per output element,
  as the reference counts its elementwise and reduce ops.
- HBM bytes: views and aliases (an op whose result aliases an input
  without writing it) and :data:`FREE` ops count 0; every other op reads
  each input and writes each output once, as eager torch does on the
  card (an input that is an expanded view is read as its storage; the
  target of ``copy_``, ``fill_`` and ``zero_`` is written, not read); a
  kernel op counts its ``work(...)`` bytes.
- Collectives (``_c10d_functional`` and ``c10d`` ops): bytes moved per
  device by the reference's ring formulas (``hlo.py``
  ``_collective_bytes``) over the op's group size; they add no FLOPs and
  no HBM bytes, as in the reference, and their helpers (``wait_tensor``)
  count nothing.

The reference weights while-loop bodies by their trip counts; the torch
step runs unrolled (a Python loop over the layers), so every op is
counted as often as it runs and nothing is weighted.

The counter also keeps the peak of the bytes held by storages that ops
created while it counted (:attr:`OpCounter.peak_bytes`): the step's
temporaries, the dry-run's ``temp_size_in_bytes``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import threading
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rms_norm as _rn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import ssd_scan as _ssd

# the kernels' registered ops: (bytes, operations) from their args
KERNEL_WORK = {
    "repro_torch.flash_attention": lambda q, k, v, scale=None:
        _fa.work(q, k),
    "repro_torch.ssd_scan": lambda X, Adt, Bc, Cc, chunk:
        _ssd.work(X, Bc, chunk),
    "repro_torch.ssd_scan_backward": lambda X, Adt, Bc, Cc, dY, chunk:
        _ssd.work_backward(X, Bc, chunk),
    "repro_torch.adamw_sumsq": lambda grads, replicas:
        _aw.sumsq_work(grads),
    "repro_torch.adamw_update": lambda params, grads, m, v, decays, *_:
        _aw.update_work(params, grads, m, v, decays),
    "repro_torch.rms_norm": lambda x, gate, w, eps: _rn.work(x, gate),
    "repro_torch.rms_norm_backward": lambda dout, x, gate, w, rstd:
        _rn.work_backward(x, gate),
    "repro_torch.selective_scan": lambda u, draw, bias, A, B, C, D, z:
        _ss.work(u, B),
    "repro_torch.selective_scan_backward":
        lambda u, draw, bias, A, B, C, D, z, kept, dy: _ss.work_backward(u, B),
}

# ops that move or fill memory and compute nothing: bytes, no FLOPs
MOVES = frozenset({
    "aten._to_copy", "aten.copy_", "aten.clone", "aten.cat",
    "aten.constant_pad_nd", "aten.repeat", "aten.zeros", "aten.ones",
    "aten.full", "aten.zeros_like", "aten.ones_like", "aten.full_like",
    "aten.new_zeros", "aten.new_ones", "aten.new_full", "aten.fill_",
    "aten.zero_", "aten.scalar_tensor", "aten.arange", "aten.index_select",
    "aten.embedding", "aten.gather", "aten.index",
})
# ops whose first argument is written without being read
WRITE_ONLY = frozenset({"aten.copy_", "aten.fill_", "aten.zero_"})
# allocations, syncs and metadata: no FLOPs, no bytes
FREE = frozenset({
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten._local_scalar_dense",
    "aten.lift_fresh_copy", "aten._unsafe_view",
})
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                         "c10d")


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_opcode: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0.0, "flops": 0.0,
                                                     "bytes": 0.0,
                                                     "collective_bytes": 0.0}))
    collectives: List[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "by_opcode": {k: dict(v) for k, v in self.by_opcode.items()},
            "collectives": self.collectives,
        }


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` read or written once: its elements, or its storage
    where that is smaller (an expanded view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (NotImplementedError, RuntimeError):
        return n


# DTensor's modules that work out an op's placements and output shape by
# running ops on fake tensors of the global shape (its sharding propagation)
# or on the mesh's tensor of ranks: work no device does
_METADATA_FILES = tuple(str(pathlib.Path("torch", "distributed", *parts))
                        for parts in (("tensor", "_sharding_prop.py"),
                                      ("tensor", "_decompositions.py"),
                                      ("tensor", "_utils.py"),
                                      ("device_mesh.py",)))


def _in_propagation(depth: int = 40) -> bool:
    """Whether the op runs inside DTensor's sharding propagation
    (:data:`_METADATA_FILES`): not counted."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_METADATA_FILES):
            return True
        f = f.f_back
    return False


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


def is_alias(func) -> bool:
    """Whether ``func`` returns a view or alias of an input that it does not
    write (``view``, ``transpose``, ``detach``, ``split``, ...)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over: its ``group_size``
    argument, its ``group_name`` resolved, or its process group's size."""
    for i, a in enumerate(func._schema.arguments):
        val = kwargs.get(a.name, args[i] if i < len(args) else None)
        if a.name == "group_size" and val is not None:
            return int(val)
        if a.name == "group_name" and val is not None:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            return _resolve_process_group(val).size()
        if a.name == "process_group" and val is not None:
            from torch.distributed import ProcessGroup
            return ProcessGroup.unbox(val).size()
    return 1


def collective_kind(name: str):
    """The collective an op of a collective namespace runs (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``, ``broadcast``), or
    None for its helpers (``wait_tensor``, autograd wrappers)."""
    op = name.split(".")[-1].replace("_", "")
    for key, kind in (("reducescatter", "reduce-scatter"),
                      ("allreduce", "all-reduce"),
                      ("allgather", "all-gather"),
                      ("alltoall", "all-to-all"), ("broadcast", "broadcast")):
        if key in op:
            return kind
    return None


def collective_bytes(kind: str, nbytes: int, n: int) -> int:
    """Bytes one device moves in a ring collective of ``nbytes`` (the
    result's, or the reduced tensor's) over ``n`` devices: the reference's
    ``hlo._collective_bytes``."""
    n = max(n, 1)
    if kind == "all-reduce":
        return int(2 * nbytes * (n - 1) / n)
    if kind == "reduce-scatter":
        return int(nbytes * (n - 1))
    if kind in ("all-gather", "all-to-all"):
        return int(nbytes * (n - 1) / n)
    return nbytes


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is entered into :attr:`summary`
    (see the module docstring); ``kernel_nodes(name)`` is how many calls
    of a kernel op it saw."""

    def __init__(self):
        super().__init__()
        self.summary = CostSummary()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = weakref.WeakValueDictionary()
        self._lock = threading.RLock()   # a finalizer may run inside

    def kernel_nodes(self, name: str) -> int:
        return int(self.summary.by_opcode.get(
            f"repro_torch.{name}", {}).get("count", 0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs; its local ops come back
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        with self._lock:
            self._count(func, args, kwargs, out)
            self._track(out, args, kwargs)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func._overloadpacket)
        if func.namespace == "prim":
            return
        s = self.summary
        kind = (collective_kind(name)
                if func.namespace in COLLECTIVE_NAMESPACES else None)
        if kind is not None:
            outs = _tensors(out) or _tensors(args[:1])
            nbytes = sum(_nbytes(t) for t in outs)
            n = group_size(func, args, kwargs)
            moved = collective_bytes(kind, nbytes, n)
            s.collective_bytes += moved
            s.by_opcode[name]["collective_bytes"] += moved
            s.by_opcode[name]["count"] += 1
            s.collectives.append({"op": name, "bytes_moved": moved,
                                  "out_bytes": nbytes, "group_size": n,
                                  "mult": 1.0, "name": str(func)})
            return
        rec = s.by_opcode[name]
        rec["count"] += 1
        if name in FREE or func.namespace in COLLECTIVE_NAMESPACES \
                or is_alias(func):
            return
        if name in KERNEL_WORK:
            nbytes, flops = KERNEL_WORK[name](*args, **kwargs)
        else:
            ins = _tensors(args[1:] if name in WRITE_ONLY else args) \
                + _tensors(kwargs)
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(out)))
            if func._overloadpacket in flop_registry:
                flops = flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            elif name in MOVES:
                flops = 0
            else:
                flops = sum(t.numel() for t in _tensors(out))
        s.flops += flops
        s.hbm_bytes += nbytes
        rec["flops"] += flops
        rec["bytes"] += nbytes

    def _track(self, out, args, kwargs) -> None:
        """Add each storage an op created (one no input holds) to the live
        bytes and the peak; a storage's bytes leave when it is freed."""
        held = {_storage_key(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            key = _storage_key(t)
            if key is None or key in held or key in self._storages:
                continue
            st = t.untyped_storage()
            nbytes = st.nbytes()
            self._storages[key] = st
            weakref.finalize(st, self._free, nbytes)
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, nbytes: int) -> None:
        with self._lock:
            self.live_bytes -= nbytes

"""AdamW over every parameter in two launches on the card: a hand-written
CUDA kernel (``repro_torch/csrc/adamw.cu``) with its plain PyTorch version
beside it and a launch counter.

Replaces no Pallas kernel: the reference's update
(``repro.train.optimizer.apply_updates``) is jnp code that XLA fuses. The
port's eager update (``train/optimizer.py``) runs about twenty elementwise
launches per tensor with float32 temporaries; the kernel does the same
arithmetic in two launches over all tensors:

- :func:`kernel_sumsq`, the norm's sum of squares: each gradient's squares summed
  in float32, divided by its replica count (a ``DTensor`` shard held by r
  ranks), the tensors' sums added in a fixed order, so the same gradients
  give the same bits on every call. The plain version is
  :func:`sumsq_plain`; the two differ only in the order of the sums.
- :func:`kernel_update`, one AdamW step in place: p, m and v read and written
  once, g read once, in :func:`update_plain`'s float32 order and rounding,
  so its p, m and v equal the plain version's bit for bit. The step's
  scale, learning rate and bias corrections stay on the device.

Both walk one table of chunks (:func:`chunk_table`): a chunk is at most
:data:`CHUNK` elements of one tensor, one block of the launch, so a large
tensor is many blocks and many small tensors share one launch. The table
(by the tensors' sizes) and the rows (each tensor's pointers, element
count, decay flag and replica count) are built on the host and copied to
the card once, then kept (:func:`plan`); the rows are copied again only
when a pointer or a flag changes, as when a gradient is allocated anew.

Inputs: float32 parameters and gradients, float32 or bfloat16 moments (one
dtype for all), p, g, m and v of each tensor on one CUDA device with one
shape and one set of strides, dense and non-overlapping (the update is
elementwise, so memory order is enough). A kernel wrapper given any other
CUDA input raises.

Two registered ops, ``torch.ops.repro_torch.adamw_sumsq`` and
``torch.ops.repro_torch.adamw_update`` (which mutates p, m and v): their
CUDA implementations launch the kernel, their CPU implementations are the
plain versions (a large tensor updated a :func:`pieces` at a time, so that
its float32 temporaries stay small), and their fake implementations let
``FakeTensorMode`` trace each as one node, which
``repro_torch.analysis.opcount`` counts as :func:`sumsq_work` and
:func:`update_work`. ``train/optimizer.py`` calls the ops for
``backend="auto"`` and the plain versions directly for ``backend="torch"``
(``_build.route``). While a profiler records, a launch of the update
adds its elements to the counter ``optimizer/kernel_elements``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import _build

# launches of the kernel in this process (the plain versions count none)
launches: Dict[str, int] = {"adamw_sumsq": 0, "adamw_update": 0}
# chunk tables and rows built and copied to a device (a step that finds
# them kept builds none)
tables_built: Dict[str, int] = {"chunks": 0, "rows": 0}

CHUNK = 1 << 15        # elements of a chunk: one block of 256 threads
PLANS_KEPT = 4         # tables kept, the most recently used

_SIGNATURES = {
    # rows, chunks, nchunks, partials, done, out, stream
    "adamw_sumsq": [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 4,
    # rows, chunks, nchunks, scale, lr, bc1, bc2, b1, 1 - b1, b2, 1 - b2,
    # eps, weight_decay, state dtype, stream
    "adamw_update": [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6
    + [ctypes.c_int, ctypes.c_void_p],
}

# columns of a row of the table (csrc/adamw.cu's Row)
ROW_P, ROW_G, ROW_M, ROW_V, ROW_N, ROW_DECAY, ROW_REPLICAS = range(7)
ROW_WIDTH = 8


def reset_launches() -> None:
    launches["adamw_sumsq"] = 0
    launches["adamw_update"] = 0
    tables_built["chunks"] = 0
    tables_built["rows"] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from source at first use."""
    return _build.load("adamw", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain versions: the eager chain of train/optimizer.py
# ---------------------------------------------------------------------------


def sumsq_plain(grads: Sequence[torch.Tensor],
                replicas: Sequence[int]) -> torch.Tensor:
    """Sum over the tensors of their squares' float32 sum over their
    replica count (a 0-d float32 tensor)."""
    return sum(torch.sum(torch.square(g.float())) / r
               for g, r in zip(grads, replicas))


# elements of a tensor updated at a time by the plain version: its float32
# temporaries (about six of this size) stay near 1.6 GB however large the
# tensor (one expert weight of dbrx-132b is 1.06 G elements); each
# element's arithmetic is the same whatever the piece
UPDATE_PIECE = 1 << 26


def pieces(*tensors):
    """The tensors cut alike into flat pieces of at most
    :data:`UPDATE_PIECE` elements (views, so an in-place update of a piece
    updates the tensor); whole where they are small or one is not
    contiguous."""
    if tensors[0].numel() <= UPDATE_PIECE \
            or not all(t.is_contiguous() for t in tensors):
        return [tensors]
    return zip(*(t.view(-1).split(UPDATE_PIECE) for t in tensors))


def update_plain(params, grads, ms, vs, decays, scale, lr, bc1, bc2,
                 b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of every tensor in place, as eager float32 ops in
    the reference's order (``apply_updates``), a large tensor a
    :func:`pieces` at a time."""
    for p_full, g_full, m_full, v_full, decay in zip(params, grads, ms, vs,
                                                     decays):
        for p, g, m, v in pieces(p_full, g_full, m_full, v_full):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * torch.square(g)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if decay:  # decoupled decay, the reference's rule
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)


# ---------------------------------------------------------------------------
# the chunk table
# ---------------------------------------------------------------------------


def chunk_table(sizes: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """(C, 3) int64: (tensor index, offset, length) of every chunk, each
    tensor of ``sizes`` elements cut into chunks of ``chunk`` elements in
    order, its last one ragged; an empty tensor has none."""
    sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
    per = -(-sizes // chunk)
    row = np.repeat(np.arange(len(sizes), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    offset = (np.arange(len(row), dtype=np.int64) - first) * chunk
    length = np.minimum(chunk, sizes[row] - offset)
    return np.stack([row, offset, length], axis=1)


class Table:
    """A chunk table on its device: ``chunks`` (C, 3) int64, the norm's
    per-chunk scratch and its finishing counter. It depends on the tensors'
    sizes alone, so it is built once for an optimizer's state."""

    def __init__(self, sizes: Sequence[int], device: torch.device):
        chunks = chunk_table(sizes)
        self.nchunks = len(chunks)
        self.chunks = _to(chunks, device)
        self.partials = torch.empty(self.nchunks, dtype=torch.float32,
                                    device=device)
        self.done = torch.zeros(1, dtype=torch.int32, device=device)
        tables_built["chunks"] += 1


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; to a card through pinned memory without waiting
    for the device (the caching host allocator keeps the pinned buffer
    until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _kept(cache: collections.OrderedDict, key, make):
    """``cache[key]``, made and kept if missing; the :data:`PLANS_KEPT`
    most recently used are kept."""
    found = cache.get(key)
    if found is not None:
        cache.move_to_end(key)
        return found
    made = cache[key] = make()
    while len(cache) > PLANS_KEPT:
        cache.popitem(last=False)
    return made


_TABLES: collections.OrderedDict = collections.OrderedDict()
_ROWS: collections.OrderedDict = collections.OrderedDict()


def plan(ptrs: Sequence[tuple], sizes: Sequence[int],
         decays: Sequence[bool], replicas: Sequence[int],
         device: torch.device) -> tuple:
    """(rows, table) of a launch: the rows, (T, 8) int64 on ``device``,
    for tensors with pointers ``ptrs`` ((p, g, m, v)
    each, 0 where unused), ``sizes`` elements, decay flags and replica
    counts on ``device``, and the chunk table of ``sizes``: each kept and
    reused while its inputs are the same. A gradient allocated anew at
    another address costs a copy of the rows (64 B a tensor), not of the
    table."""
    sizes = tuple(sizes)
    table = _kept(_TABLES, (device, sizes), lambda: Table(sizes, device))

    def rows():
        a = np.zeros((len(sizes), ROW_WIDTH), dtype=np.int64)
        if sizes:
            a[:, ROW_P:ROW_V + 1] = np.asarray(ptrs, dtype=np.int64)
        a[:, ROW_N] = sizes
        a[:, ROW_DECAY] = decays
        a[:, ROW_REPLICAS] = replicas
        tables_built["rows"] += 1
        return _to(a, device)

    key = (device, tuple(ptrs), sizes, tuple(decays), tuple(replicas))
    return _kept(_ROWS, key, rows), table


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``numel`` consecutive places of its
    storage, each once (dense and non-overlapping, in any dim order)."""
    if t.numel() == 0:
        return True
    expect = 1
    for st, n in sorted((st, n) for st, n in zip(t.stride(), t.shape)
                        if n != 1):
        if st != expect:
            return False
        expect *= n
    return True


def _check_grads(grads: Sequence[torch.Tensor]) -> int:
    """Raise unless every gradient fits the kernel; their device index."""
    _build.check_cuda("adamw", grads[0])
    dev = grads[0].get_device()
    for i, g in enumerate(grads):
        if g.get_device() != dev:
            raise ValueError(f"the adamw kernel takes tensors on one "
                             f"device; gradient {i} is on {g.device}, the "
                             f"first on {grads[0].device}")
        if g.dtype is not torch.float32:
            raise ValueError(f"the adamw kernel takes float32 gradients; "
                             f"gradient {i} is {g.dtype}")
        if not dense(g):
            raise ValueError(f"the adamw kernel walks each tensor in memory "
                             f"order: gradient {i} (shape {tuple(g.shape)}, "
                             f"strides {g.stride()}) is not dense and "
                             f"non-overlapping")
    return dev


def _check_update(params, grads, ms, vs) -> torch.dtype:
    """Raise unless the lists fit the kernel; the moments' dtype."""
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"{len(params)} parameters, {len(grads)} gradients,"
                         f" {len(ms)} and {len(vs)} moments")
    dev = _check_grads(grads)
    sdt, f32 = ms[0].dtype, torch.float32
    if sdt not in _build.DTYPE_CODES:
        raise ValueError(f"the adamw kernel takes float32 or bfloat16 "
                         f"moments; got {sdt}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if p.dtype is not f32 or m.dtype is not sdt or v.dtype is not sdt:
            raise ValueError(f"the adamw kernel takes float32 parameters and "
                             f"moments of one dtype ({sdt}); tensor {i} has "
                             f"{p.dtype}, {m.dtype}, {v.dtype}")
        if p.get_device() != dev or m.get_device() != dev \
                or v.get_device() != dev:
            raise ValueError(f"tensor {i}: p, g, m and v must be on "
                             f"{g.device}")
        st, shape = g.stride(), g.shape
        if p.stride() != st or m.stride() != st or v.stride() != st \
                or p.shape != shape or m.shape != shape or v.shape != shape:
            raise ValueError(f"tensor {i}: p, g, m and v need one shape and "
                             f"one set of strides; got strides {p.stride()},"
                             f" {st}, {m.stride()}, {v.stride()}")
    return sdt


def kernel_sumsq(grads: Sequence[torch.Tensor],
                 replicas: Sequence[int]) -> torch.Tensor:
    """The sum of squares on the card, in one launch: the chunks' sums and,
    in the block that finishes last, their total."""
    _check_grads(grads)
    dev = grads[0].device
    sizes = [g.numel() for g in grads]
    if not sum(sizes):
        return torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    rows, table = plan([(0, g.data_ptr(), 0, 0) for g in grads], sizes,
                       [False] * len(grads), replicas, dev)
    with torch.cuda.device(dev):
        _build.raise_on(library().adamw_sumsq(
            rows.data_ptr(), table.chunks.data_ptr(), table.nchunks,
            table.partials.data_ptr(), table.done.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "adamw_sumsq")
    launches["adamw_sumsq"] += 1
    return out


def kernel_update(params, grads, ms, vs, decays, scale, lr, bc1, bc2,
                  b1: float, b2: float, eps: float,
                  weight_decay: float) -> None:
    """One AdamW step of every tensor on the card, in place."""
    sdt = _check_update(params, grads, ms, vs)
    dev = grads[0].device
    scalars = (scale, lr, bc1, bc2)
    if any(s.device != dev or s.dtype != torch.float32 or s.numel() != 1
           for s in scalars):
        raise ValueError("scale, lr, bc1 and bc2 must be float32 scalars "
                         f"on {dev}")
    sizes = [p.numel() for p in params]
    if not sum(sizes):
        return
    rows, table = plan([(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr()) for p, g, m, v in
                        zip(params, grads, ms, vs)], sizes,
                       [bool(d) for d in decays], [1] * len(params), dev)
    with torch.cuda.device(dev):
        _build.raise_on(library().adamw_update(
            rows.data_ptr(), table.chunks.data_ptr(), table.nchunks,
            *(s.data_ptr() for s in scalars), b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, _build.DTYPE_CODES[sdt],
            torch.cuda.current_stream().cuda_stream), "adamw_update")
    launches["adamw_update"] += 1
    spans.count("optimizer/kernel_elements", sum(sizes))


# ---------------------------------------------------------------------------
# the registered ops and their work
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::adamw_sumsq", mutates_args=(),
                         device_types="cpu")
def sumsq_op(grads: List[torch.Tensor], replicas: List[int]) -> torch.Tensor:
    """The registered op: the plain version on the CPU, the kernel on the
    card (:func:`kernel_sumsq`)."""
    return sumsq_plain(grads, replicas)


@sumsq_op.register_kernel("cuda")
def _sumsq_cuda(grads, replicas):
    return kernel_sumsq(grads, replicas)


@sumsq_op.register_fake
def _sumsq_fake(grads, replicas):
    return grads[0].new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_update",
                         mutates_args=("params", "m", "v"),
                         device_types="cpu")
def update_op(params: List[torch.Tensor], grads: List[torch.Tensor],
              m: List[torch.Tensor], v: List[torch.Tensor],
              decays: List[bool], scale: torch.Tensor, lr: torch.Tensor,
              bc1: torch.Tensor, bc2: torch.Tensor, b1: float, b2: float,
              eps: float, weight_decay: float) -> None:
    """The registered op: the plain version on the CPU
    (:func:`update_plain`), the kernel on the card
    (:func:`kernel_update`)."""
    update_plain(params, grads, m, v, decays, scale, lr, bc1, bc2, b1, b2,
                 eps, weight_decay)


@update_op.register_kernel("cuda")
def _update_cuda(params, grads, m, v, decays, scale, lr, bc1, bc2, b1, b2,
                 eps, weight_decay):
    kernel_update(params, grads, m, v, decays, scale, lr, bc1, bc2, b1, b2,
                  eps, weight_decay)


@update_op.register_fake
def _update_fake(params, grads, m, v, decays, scale, lr, bc1, bc2, b1, b2,
                 eps, weight_decay):
    return None


# operations of one element's update: the scaled gradient (1), m (3), v
# (4), the step m_hat / (sqrt(v_hat) + eps) (5), p - lr * delta (2); and 2
# more (decay times p, added) where the tensor decays
UPDATE_OPS, DECAY_OPS = 15, 2


def sumsq_work(grads) -> tuple:
    """(bytes, operations) of the sum of squares: each gradient read once
    (4 B an element), a multiply and an add an element."""
    n = sum(g.numel() for g in grads)
    return 4 * n, 2 * n


def update_work(params, grads, ms, vs, decays) -> tuple:
    """(bytes, operations) of the update: p, m and v read and written
    once, g read once (28 B an element with float32 moments, 20 with
    bfloat16); :data:`UPDATE_OPS` an element and :data:`DECAY_OPS` more
    where the tensor decays."""
    nbytes = ops = 0
    for p, g, m, v, d in zip(params, grads, ms, vs, decays):
        n = p.numel()
        nbytes += n * (2 * p.element_size() + g.element_size()
                       + 2 * m.element_size() + 2 * v.element_size())
        ops += n * (UPDATE_OPS + (DECAY_OPS if d else 0))
    return nbytes, ops

"""Device meshes and the process groups under them, ported from
``repro.launch.mesh``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over a
process group of one rank per device, which must exist before
:func:`make_mesh` is called (:func:`init_process_group`, or
:func:`spawn` to start the ranks). The group meets through a
``FileStore`` in a directory, so no network port is opened: ``gloo`` on
the CPU, ``nccl`` on the card, one card per rank. Asking for ``cuda``
with more ranks than ``torch.cuda.device_count()`` raises; nothing falls
back to ``gloo`` or to the CPU.

:func:`make_abstract_mesh` needs no devices and no process group: the
rule functions of ``repro_torch.distributed.sharding`` read only its
``.shape`` (axis name -> size) and ``.axis_names``, as the reference's
read an ``AbstractMesh``.

:func:`make_fake_mesh` builds a ``DeviceMesh`` over a fake process group
(torch's ``FakeProcessGroup``: one rank in this process stands for all,
and no collective moves data), for the dry-run, whose tensors are fake:
it is the only mesh that may have more ranks than cards.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and their sizes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def _check_ranks(world_size: int, device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{world_size} ranks asked for on cuda, but "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}: "
            "NCCL puts one rank on each card")
    return dev


def init_process_group(rank: int, world_size: int, store_path: str, *,
                       device="cuda") -> torch.device:
    """Join the group of ``world_size`` ranks that meet at the file
    ``store_path`` (every rank passes the same path; the file must not
    exist before the first rank joins). On ``cuda`` the rank's card is
    ``rank``. Returns the rank's device."""
    dev = _check_ranks(world_size, device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world_size)
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    of this process, whose world size must be ``prod(shape)``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    dev = _check_ranks(n, device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_process_group (or spawn) first")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_fake_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process group
    of ``prod(shape)`` ranks, this process being rank 0. No rank count is
    held against the cards: no tensor on this mesh need be real. A fake
    group of another size is replaced; a real group raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group exists; "
                               "a fake mesh needs its own process")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         fake: bool = False):
    """The reference's production mesh, (16, 16) or (2, 16, 16); with
    ``fake`` over a fake process group (:func:`make_fake_mesh`, the
    dry-run's), else over this process's real group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        return make_fake_mesh(shape, axes, device=device)
    return make_mesh(shape, axes, device=device)


def data_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for name in ("pod", "data"):
        if name in sizes:
            size *= sizes[name]
    return size


def _rank_main(rank, fn, world_size, store_path, device, args):
    if torch.device(device).type == "cpu":  # the ranks share the threads
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    init_process_group(rank, world_size, store_path, device=device)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, device="cuda",
          args: Sequence = ()) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each joined to one process group (a ``FileStore`` in a
    fresh temporary directory) and left again when ``fn`` returns; raises
    if a rank fails. ``fn`` must be importable (a module-level function)."""
    _check_ranks(world_size, device)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        mp.spawn(_rank_main, args=(fn, world_size,
                                   os.path.join(tmp, "store"), device,
                                   tuple(args)),
                 nprocs=world_size, join=True)

"""Step-atomic checkpointing, ported from ``repro.train.checkpoint``.

Layout (the reference's):  <dir>/step_<N>/
            manifest.json     tree structure + per-leaf dtype/shape
            leaf_00000.npy    one file per leaf (copied to the host)
         <dir>/step_<N>.tmp/  staging dir — renamed only when complete, so a
                              preemption mid-save never corrupts the latest
                              checkpoint (rename is atomic on POSIX).

A tree is nested dicts whose leaves are tensors, numpy arrays or numbers; a
leaf's path is its keys joined by ``/`` (``params/blocks.0.attn.wq``,
``opt/m/final_norm``). bfloat16 tensors are stored as their ``uint16`` bit
patterns, as the reference stores them.
Every leaf is written from host memory and read back into host memory, so
a checkpoint saved on the card restores on the CPU, or on any device
(``restore(..., device=...)``). Reading a ``repro`` checkpoint is not
supported: its leaf paths are ``jax.tree_util.keystr`` strings of the
stacked parameter tree.

Under a mesh, :func:`save` is called by every rank: each ``DTensor`` leaf
is gathered whole (a collective), rank 0 writes the files, the same layout
as one device's, and the ranks meet again before it returns. Restore never
needs the saving mesh: a leaf comes back on the *restoring* mesh with the
placements ``restore(..., mesh=, placements=)`` gives it — the elastic
re-mesh path (e.g. a (2, 2) save restored on (2, 1) or on one
device, ``checkpoint.py:96-130`` of the reference).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import full, is_dtensor

_STEP_RE = re.compile(r"^step_(\d+)$")



def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten_like(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    return leaves[prefix.rstrip("/")]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = full(leaf.detach()).cpu().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16), dtype
        return t.numpy(), dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir, step: int, tree, *, keep: int = 3) -> pathlib.Path:
    """Write checkpoint for ``step``; prune to the newest ``keep``. A tree
    with ``DTensor`` leaves is saved by every rank together (rank 0
    writes)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step}"
    flat = _flatten(tree)
    meshed = any(is_dtensor(leaf) for _, leaf in flat)
    if meshed and dist.get_rank() != 0:
        for _, leaf in flat:      # take part in every gather, write nothing
            if is_dtensor(leaf):
                full(leaf.detach())
        dist.barrier()
        return final
    tmp = ckpt_dir / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "dtype": dtype,
                                   "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    _prune(ckpt_dir, keep)
    if meshed:
        dist.barrier()
    return final


def _prune(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> List[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = _STEP_RE.match(p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, like, *, device=None, mesh=None,
            placements=None):
    """Load ``step`` into the structure of ``like`` (nested dicts of
    tensors, arrays or numbers). Every leaf comes back as a tensor of its
    saved dtype, on ``device`` if given, else on the device of its ``like``
    tensor (the CPU for arrays and numbers). A leaf whose path is in
    ``placements`` (path -> placements on ``mesh``) comes back as a
    ``DTensor`` on ``mesh``, each rank keeping its own shard. Raises
    KeyError for a leaf the checkpoint lacks and ValueError for one of
    another shape."""
    src = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((src / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = {}
    for path, leaf in _flatten(like):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(src / entry["file"])
        want_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {path!r}: checkpoint shape {arr.shape} != {want_shape}")
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        t = t.to(dev)
        if placements and path in placements:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, mesh, placements[path],
                                  src_data_rank=None)
        leaves[path] = t
    return _unflatten_like(like, leaves)


def restore_latest(ckpt_dir, like, *, device=None, mesh=None,
                   placements=None):
    """(step, tree) for the newest checkpoint, or (None, None)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like, device=device, mesh=mesh,
                         placements=placements)

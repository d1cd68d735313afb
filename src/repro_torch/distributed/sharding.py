"""Logical-axis sharding on a ``DeviceMesh``, ported from
``repro.distributed.sharding``.

Models name every parameter's dims with *logical* axes
(``models.model.param_axes``); a rule table maps logical names to mesh
axes. A spec here is a tuple with one entry per tensor dim (a mesh axis
name, a tuple of names, or None), trailing Nones trimmed: the reference's
``PartitionSpec`` as a plain tuple. :func:`placements` turns it into
DTensor placements, one per mesh dim. Activations are constrained inside
model code by :func:`constrain`, which redistributes a ``DTensor`` and
leaves any other tensor as it is, so the one-device paths run unchanged.

The rule functions read only a mesh's axis names and sizes, so they take
a ``DeviceMesh`` or a device-free ``launch.mesh.AbstractMesh``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# ---------------------------------------------------------------------------
# Rule tables (logical axis name -> mesh axis / axes), the reference's
# ---------------------------------------------------------------------------

# Parameters: FSDP over 'data', tensor parallel over 'model'. Parameters are
# replicated across pods ('pod' carries pure data parallelism + the cross-pod
# gradient all-reduce).
PARAM_RULES = {
    "embed": "data",        # FSDP axis (d_model dims)
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,       # 8 kv heads don't divide model=16 -> replicate
    "kv_head_dim": "model", # shard KV projections on head_dim instead
    "head_dim": None,
    "mlp": "model",
    "expert": "model",      # expert parallelism (when divisible)
    "expert_mlp": "model",  # per-expert d_ff TP (when experts don't divide)
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "rglru_width": "model",
    "conv_width": None,
    "layers": None,
    "groups": None,
    None: None,
}

# Activations.
ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",   # sequence-parallel sections / sharded KV cache seq
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "kv_head_dim": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "rglru_width": "model",
    "layers": None,
    None: None,
}

@contextlib.contextmanager
def use_mesh(mesh):
    """The scope of a step on ``mesh``. With a ``DeviceMesh``, a plain
    tensor that meets a ``DTensor`` in an op inside counts as replicated
    (DTensor's ``implicit_replication``): the positions, masks and
    constants the model code makes on the fly. Code that needs the mesh
    reads it from its ``DTensor``s (``x.device_mesh``), so the reference's
    ``current_mesh`` has no counterpart."""
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        yield mesh
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield mesh


def _trim(out: list) -> Spec:
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _resolve(rules: dict, logical: Sequence[Optional[str]], mesh) -> Spec:
    names = set(axis_names(mesh))
    out = []
    for ax in logical:
        phys = rules.get(ax, None)
        if isinstance(phys, tuple):
            phys = tuple(p for p in phys if p in names) or None
            if phys is not None and len(phys) == 1:
                phys = phys[0]
        elif phys is not None and phys not in names:
            phys = None
        out.append(phys)
    return _trim(out)


def param_spec(logical: Sequence[Optional[str]], mesh) -> Spec:
    return _resolve(PARAM_RULES, logical, mesh)


def act_spec(logical: Sequence[Optional[str]], mesh) -> Spec:
    return _resolve(ACT_RULES, logical, mesh)


def _axis_size(mesh, phys) -> int:
    if phys is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(phys, tuple):
        out = 1
        for p in phys:
            out *= sizes[p]
        return out
    return sizes[phys]


def fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes that do not evenly divide the corresponding dim —
    keeps tiny/odd dims (batch=1 decode, 6-head models) replicated instead
    of tripping uneven-sharding paths."""
    out = []
    for i, phys in enumerate(spec):
        if phys is not None and (i >= len(shape)
                                 or shape[i] % _axis_size(mesh, phys) != 0):
            phys = None
        out.append(phys)
    return _trim(out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: the
    tensor dim a mesh axis shards, or ``Replicate`` (also for an axis of
    size 1, which splits nothing). A tensor dim over two
    mesh axes (``"batch"`` -> ``("pod", "data")``) is ``Shard`` on both,
    split in mesh-dim order (the first mesh axis major, as the reference's
    ``PartitionSpec(("pod", "data"))``)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for i, phys in enumerate(spec):
        for name in (phys if isinstance(phys, tuple) else (phys,)):
            if name is not None:
                dim_of[name] = i
    sizes = axis_sizes(mesh)
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in axis_names(mesh))


def spec_placements(rules: str, logical, shape, mesh) -> tuple:
    """Placements of a tensor of ``shape`` whose dims are ``logical``,
    under the ``"param"`` or ``"act"`` rule table, non-dividing axes
    dropped (:func:`fit_spec`)."""
    spec = (param_spec if rules == "param" else act_spec)(logical, mesh)
    return placements(fit_spec(spec, tuple(shape), mesh), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *logical: Optional[str]):
    """Redistribute ``x`` to the activation placements of ``logical`` on its
    own mesh; a tensor that is not a ``DTensor`` (no mesh) comes back as
    it is."""
    if not is_dtensor(x):
        return x
    want = spec_placements("act", logical, x.shape, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def full(x):
    """A ``DTensor`` gathered whole as a plain tensor (a collective: every
    rank calls it); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x):
    """This rank's shard of a ``DTensor`` (the tensor itself, in place
    under ``no_grad``); a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def replicas(x) -> int:
    """How many ranks hold each element of ``x``: the product of the mesh
    dims it is replicated over (1 for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for md, p in enumerate(x.placements):
        if p.is_replicate():
            n *= x.device_mesh.size(md)
        elif not p.is_shard():
            raise ValueError(f"{p} placement: reduce it first")
    return n


def distribute_params(model: torch.nn.Module, mesh,
                      placements_by_name: Dict[str, tuple]) -> None:
    """Replace each parameter of ``model`` by a ``DTensor`` parameter on
    ``mesh`` with its placements; every rank holds the whole value, and
    keeps its own shard of it (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = distribute_tensor(p.detach(), mesh, placements_by_name[name],
                              src_data_rank=None)
        setattr(mod, attr, torch.nn.Parameter(d, requires_grad=p.requires_grad))


def mesh_dim_of(x, dim: int) -> Optional[int]:
    """The one mesh dim that shards ``x``'s dim ``dim``, or None where
    ``x`` is not a ``DTensor`` or that dim is whole (a dim over two
    mesh axes raises)."""
    if not is_dtensor(x):
        return None
    mds = [md for md, p in enumerate(x.placements) if p.is_shard(dim)]
    if len(mds) > 1:
        raise ValueError(f"dim {dim} over mesh dims {mds}: one expected")
    return mds[0] if mds else None


def unshard(x, dim: int):
    """``x`` with its dim ``dim`` whole on every rank (every mesh dim that
    shards it gathered); other placements, and a plain tensor, as they
    are."""
    if not is_dtensor(x) or not any(p.is_shard(dim) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def split_heads(x, heads: int, head_dim: int):
    """``x`` (..., heads * head_dim) as (..., heads, head_dim). A ``DTensor``
    is split on each rank's shard (:func:`shard_local`), its last dim
    gathered first where its mesh dim does not divide ``heads``, so that
    neither the split nor its gradient's flatten meets uneven shards,
    which DTensor refuses (mamba2-130m's 24 SSD heads on a model axis of
    16)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], heads, head_dim)
    last = x.dim() - 1
    md = mesh_dim_of(x, last)
    if md is not None and heads % x.device_mesh.size(md):
        x = unshard(x, last)
    return shard_local(lambda xl, heads: split_heads(
        xl, xl.shape[-1] // head_dim, head_dim), (x,), (last,))


def merge_heads(x):
    """``x`` (..., heads, head_dim) as (..., heads * head_dim), the inverse
    of :func:`split_heads`: a ``DTensor`` on each rank's shard, heads
    gathered where the mesh does not divide them."""
    if is_dtensor(x):
        return shard_local(lambda xl, heads: merge_heads(xl), (x,),
                           (x.dim() - 2,))
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def is_axes_leaf(t) -> bool:
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


def tree_param_shardings(axes: Dict[str, tuple], mesh,
                         shapes: Optional[Dict[str, tuple]] = None
                         ) -> Dict[str, tuple]:
    """Parameter name -> placements from its logical axes. With ``shapes``
    (name -> shape, or anything with ``.shape``), non-dividing axes are
    dropped per tensor via :func:`fit_spec`."""
    return _tree("param", axes, mesh, shapes)


def tree_act_shardings(axes: Dict[str, tuple], mesh,
                       shapes: Optional[Dict[str, tuple]] = None
                       ) -> Dict[str, tuple]:
    """Same as :func:`tree_param_shardings` with the activation rules."""
    return _tree("act", axes, mesh, shapes)


def _tree(rules, axes, mesh, shapes):
    resolve = param_spec if rules == "param" else act_spec
    out = {}
    for name, logical in axes.items():
        spec = resolve(logical, mesh)
        if shapes is not None:
            s = shapes[name]
            spec = fit_spec(spec, tuple(getattr(s, "shape", s)), mesh)
        out[name] = placements(spec, mesh)
    return out


def distribute_tree(tensors: Dict[str, torch.Tensor], mesh,
                    placements_by_name: Dict[str, tuple]) -> dict:
    """Each tensor as a ``DTensor`` on ``mesh`` with its placements (the
    reference's ``in_shardings`` applied to a tree of arrays); every rank
    holds the whole value and keeps its own shard (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(t, mesh, placements_by_name[k],
                                 src_data_rank=None)
            for k, t in tensors.items()}


def validate_axes(params: Dict[str, torch.Tensor],
                  axes: Dict[str, tuple]) -> None:
    """Check the axes match the parameters name for name, rank too."""
    if set(params) != set(axes):
        raise ValueError(
            f"params/axes mismatch: {len(params)} params vs {len(axes)} "
            f"axes; only in params {sorted(set(params) - set(axes))[:4]}, "
            f"only in axes {sorted(set(axes) - set(params))[:4]}")
    for name, p in params.items():
        if not is_axes_leaf(axes[name]):
            raise ValueError(f"axes of {name!r} are not a tuple of names: "
                             f"{axes[name]!r}")
        if hasattr(p, "dim") and len(axes[name]) != p.dim():
            raise ValueError(f"axes {axes[name]} rank != param shape "
                             f"{tuple(p.shape)} ({name!r})")


WHOLE = "whole"  # a shard_local arg with no batch dim, whole on every rank


def shard_local(fn, args, head_dims, *, reduced: bool = False):
    """``fn`` on this rank's shards of ``args`` (``DTensor``s), as a
    reference ``shard_map`` region runs its body: a kernel sees plain
    local tensors only.

    ``args[0]`` sets the layout: its dim 0 (the batch) and, unless
    ``head_dims[0]`` is None, its dim ``head_dims[0]`` (the heads) may be
    sharded, each over mesh dims that divide it evenly; any other sharding
    is gathered first. For each other arg,
    ``head_dims[i]``:

    - a dim: the arg has the same batch rows and is sharded along that dim
      as ``args[0]`` is along its heads;
    - None: the arg has the same batch rows and comes whole over the
      heads' mesh axes (k and v of GQA, the SSD's B and C); its gradient
      is the sum of the ranks' (``Partial``) there;
    - :data:`WHOLE`: the arg has no batch dim and comes whole to every rank
      (a parameter); its gradient is summed over every mesh axis that
      shards ``args[0]``.

    ``fn(*locals, heads=(h0, n))`` learns the global index of its first
    head and their count. Each output of ``fn`` (a tensor or a tuple of
    them) has ``args[0]``'s layout; with ``reduced``, ``fn`` has combined
    the ranks' parts over the mesh dims that shard the head dim itself
    (:func:`all_reduce`), and each output is whole over them.

    The "heads" dim may be any dim the ranks split and ``fn`` combines:
    ``layers.decode_attention`` names the cache's sequence."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = args[0]
    mesh, hd = x.device_mesh, head_dims[0]

    def even(p, md):   # an uneven split (24 heads over 16) is gathered
        return x.shape[p.dim] % mesh.size(md) == 0

    x_pl = tuple(p if p.is_shard() and (p.dim == 0 or p.dim == hd)
                 and even(p, md) else Replicate()
                 for md, p in enumerate(x.placements))

    def heads(p):
        return hd is not None and p.is_shard(hd)

    if x_pl != tuple(x.placements):
        x = x.redistribute(mesh, x_pl)
    local = [x.to_local()]
    for a, dim in zip(args[1:], head_dims[1:]):
        pl, grad = [], []
        for p in x_pl:
            if dim == WHOLE:
                pl.append(Replicate())
                grad.append(Replicate() if p.is_replicate() else Partial())
            elif p.is_shard(0):
                pl.append(Shard(0))
                grad.append(Shard(0))
            elif heads(p) and dim is not None:
                pl.append(Shard(dim))
                grad.append(Shard(dim))
            else:
                pl.append(Replicate())
                grad.append(Partial() if heads(p) else Replicate())
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        local.append(a.to_local(grad_placements=grad))
    idx, n = 0, 1
    for md, p in enumerate(x_pl):
        if heads(p):
            idx = idx * mesh.size(md) + mesh.get_local_rank(md)
            n *= mesh.size(md)
    per = x.shape[hd] // n if hd is not None else 0
    out = fn(*local, heads=(idx * per, per))

    out_pl = tuple(Replicate() if reduced and heads(p) else p for p in x_pl)

    def wrap(t):
        return DTensor.from_local(t, mesh, out_pl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def all_reduce(t: torch.Tensor, op: str, mesh, mesh_dim: int) -> torch.Tensor:
    """A plain tensor reduced (``"sum"``, ``"max"``) over the ranks of one
    mesh dim, each rank getting the result: one functional collective,
    which the op counter and a fake process group both see."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t, op, (mesh, mesh_dim))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def local_index(x, dim: int, i: int) -> Optional[int]:
    """Where global index ``i`` of ``x``'s dim ``dim`` lies in this rank's
    shard, or None where another rank holds it: ``i`` for a plain tensor
    or a dim that is whole. The mesh dims that shard ``dim`` split it in
    mesh-dim order, each as ``torch.chunk`` does (DTensor's ``Shard``)."""
    if not is_dtensor(x):
        return i
    mesh = x.device_mesh
    start, length = 0, x.shape[dim]
    for md, p in enumerate(x.placements):
        if p.is_shard(dim):
            n = mesh.size(md)
            chunk = -(-length // n)
            c = mesh.get_local_rank(md)
            start += c * chunk
            length = max(0, min(chunk, length - c * chunk))
    return i - start if start <= i < start + length else None

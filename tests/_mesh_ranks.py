"""Rank-side code of the port's multi-rank CPU tests: each function runs in
one ``gloo`` rank started by ``repro_torch.launch.mesh.spawn`` (spawned
processes import it from this directory) and reads and writes its inputs
and results as pickles, rank 0 writing."""
import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist


def _cfg(arch, dtype):
    from repro_torch.configs import base as CB
    return dataclasses.replace(CB.get_config(arch, smoke=True), dtype=dtype)


def load_params(trainer, named):
    """Write the whole tensors ``named`` (port names -> numpy) into the
    trainer's parameters, each rank its own shards."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import is_dtensor, local
    with torch.no_grad():
        for name, p in trainer.params.items():
            t = torch.from_numpy(np.asarray(named[name]))
            if is_dtensor(p):
                t = distribute_tensor(t, p.device_mesh, p.placements,
                                      src_data_rank=None)
            local(p).copy_(local(t))


def gathered(trainer):
    """Every parameter and moment whole, as numpy copies (a collective; a
    replicated DTensor's whole value is its local tensor, which later
    steps update in place)."""
    from repro_torch.distributed.sharding import full
    return {"params": {k: full(p.detach()).numpy().copy()
                       for k, p in trainer.params.items()},
            "m": {k: full(v).numpy().copy()
                  for k, v in trainer.opt_state["m"].items()}}


def train(rank, world, job_path):
    """Build a ``Trainer`` on ``job["mesh"]`` (shape, axes), load
    ``job["params"]``, optionally restore ``job["restore_dir"]`` first, run
    ``job["steps"]`` steps (saving to ``job["ckpt_dir"]`` at the end when
    given), and write the history and the gathered state."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = _train(job)
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(out, f)


def _train(job) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig
    torch.set_num_threads(1)
    cfg = _cfg(job["arch"], job["dtype"])
    mesh = make_mesh(job["mesh"][0], job["mesh"][1], device="cpu")
    tc = TrainConfig(seq_len=job["seq"], global_batch=job["batch"],
                     num_steps=job["steps"], log_every=0, ckpt_every=0,
                     ckpt_dir=job.get("ckpt_dir") or job.get("restore_dir"))
    tr = Trainer(cfg, tc, hp=OptHParams(**job["hp"]), mesh=mesh,
                 device="cpu")
    if job.get("params") is not None:
        load_params(tr, job["params"])
    out = {"rank_placements": {k: tuple(v.placements)
                               for k, v in tr.params.items()}}
    if job.get("restore_dir"):
        out["restored"] = tr.maybe_restore()
        out["resume_step"] = tr.step
        out["after_restore"] = gathered(tr)
    for _ in range(job["steps"]):
        tr.train_one()
    if job.get("ckpt_dir"):
        tr.save()
    out.update(history=tr.history, state=gathered(tr),
               world=dist.get_world_size())
    return out


def _gather_to_rank0(t):
    """(world, *t.shape) on rank 0 (an all-gather: every rank calls it)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).numpy()


def psum(rank, world, job_path):
    """``compressed_psum`` of rank ``rank``'s slice of each case's (world,
    ...) gradients and residuals; rank 0 writes every rank's mean and new
    residual, stacked."""
    from repro_torch.distributed.compression import compressed_psum
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    res = []
    for g, r in job["cases"]:
        out, new_r = compressed_psum(
            {"w": torch.from_numpy(g[rank])}, {"w": torch.from_numpy(r[rank])})
        res.append((_gather_to_rank0(out["w"]), _gather_to_rank0(new_r["w"])))
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump({"res": res, "world": world}, f)


def pipeline(rank, world, job_path):
    """``pipeline_apply`` of ``tanh(h @ w + b)`` blocks over a (world,)
    ``("pod",)`` mesh; rank 0 writes every rank's result, stacked."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh((world,), ("pod",), device="cpu")
    params = {k: torch.from_numpy(v) for k, v in job["params"].items()}

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(block, params, torch.from_numpy(job["x"]),
                         mesh=mesh, axis="pod",
                         microbatches=job["microbatches"])
    got = _gather_to_rank0(out)
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump({"out": got, "world": world}, f)


def moe_functions(rank, world, job_path):
    """``moe.Dispatch`` / ``moe.Combine`` on a batch-sharded (2, 2) mesh:
    the forward and the gradient of each against the other applied on one
    device to the cotangent cast to bfloat16; rank 0 writes the largest
    differences."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    src, eo, ct_d, ct_c, flat_e, pos = (torch.from_numpy(job[k]) for k in (
        "src", "eo", "ct_d", "ct_c", "flat_e", "pos"))
    E, C = eo.shape[1], eo.shape[2]

    def dist_(t):
        return distribute_tensor(t, mesh, SH.spec_placements(
            "act", ("batch",) + (None,) * (t.dim() - 1), t.shape, mesh),
            src_data_rank=None)
    errs = {}
    with SH.use_mesh(mesh):
        s = dist_(src).requires_grad_(True)
        out = MOE.Dispatch.apply(s, dist_(flat_e), dist_(pos), E, C)
        (out * dist_(ct_d)).sum().backward()
        errs["dispatch"] = float((SH.full(out) - MOE.dispatch_local(
            src, flat_e, pos, E, C)).abs().max())
        want = MOE.combine_local(ct_d.to(torch.bfloat16), flat_e, pos).float()
        errs["dispatch_grad"] = float((SH.full(s.grad) - want).abs().max())
        errs["dispatch_grad_vs_f32"] = float(
            (want - MOE.combine_local(ct_d, flat_e, pos)).abs().max())
        o = dist_(eo).requires_grad_(True)
        out = MOE.Combine.apply(o, dist_(flat_e), dist_(pos))
        (out * dist_(ct_c)).sum().backward()
        errs["combine"] = float((SH.full(out) - MOE.combine_local(
            eo, flat_e, pos)).abs().max())
        want = MOE.dispatch_local(ct_c.to(torch.bfloat16), flat_e, pos, E,
                                  C).float()
        errs["combine_grad"] = float((SH.full(o.grad) - want).abs().max())
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(errs, f)


# ---------------------------------------------------------------------------
# test-process side (imports JAX; never called in a rank)
# ---------------------------------------------------------------------------

HP = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)

_JAX_TRAIN = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys, pickle, dataclasses
sys.path.insert(0, "src")
import jax, numpy as np
from repro.configs import base as CB
from repro.train.optimizer import OptHParams
from repro.train.trainer import Trainer, TrainConfig
job = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(CB.get_config(job["arch"], smoke=True),
                          dtype=job["dtype"])
# Auto axes: jax 0.9.0's jax.make_mesh builds Explicit ones, on which the
# reference's trainer stops at its embedding gather
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
tc = TrainConfig(seq_len=job["seq"], global_batch=job["batch"],
                 num_steps=job["steps"], log_every=0)
tr = Trainer(cfg, tc, hp=OptHParams(**job["hp"]), mesh=mesh)
init = jax.tree.map(np.asarray, tr.params)
tr.run()
pickle.dump({"init": init, "final": jax.tree.map(np.asarray, tr.params),
             "history": tr.history, "devices": jax.device_count()},
            open(sys.argv[2], "wb"))
"""

_TORCH_RANKS = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import _mesh_ranks
from repro_torch.launch.mesh import spawn
spawn(getattr(_mesh_ranks, sys.argv[1]), int(sys.argv[2]), device="cpu",
      args=(sys.argv[3],))
"""


def _run(argv, cwd):
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", *argv], capture_output=True,
                         text=True, cwd=cwd, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def reference_train(repo, tmp, arch, seq, steps=3, batch=4, dtype="float32"):
    """The reference ``Trainer`` on the Auto-axis (2, 2) mesh of 4 forced
    host devices: its initial and final parameter trees and history."""
    job, out = tmp / f"jax_{arch}.pkl", tmp / f"jax_{arch}_out.pkl"
    with open(job, "wb") as f:
        pickle.dump(dict(arch=arch, dtype=dtype, seq=seq, batch=batch,
                         steps=steps, hp=HP), f)
    _run([_JAX_TRAIN, str(job), str(out)], repo)
    with open(out, "rb") as f:
        return pickle.load(f)


def ranks(repo, tmp, fn: str, world: int, job: dict, name: str):
    """Run ``fn`` of this module on ``world`` gloo ranks with ``job``;
    returns what rank 0 wrote."""
    path, out = tmp / f"{name}.pkl", tmp / f"{name}_out.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(job, out=str(out)), f)
    _run([_TORCH_RANKS, fn, str(world), str(path)], repo)
    with open(out, "rb") as f:
        return pickle.load(f)


def port_names(arch, dtype, tree):
    """A reference parameter tree (numpy) keyed by the port's names."""
    from repro_torch.convert import lm_from_numpy
    model = lm_from_numpy(_cfg(arch, dtype), tree, device="cpu")
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def one_device(arch, dtype, params, seq, steps, batch=4, ckpt_dir=None,
               restore=False):
    """The port's ``mesh=None`` trainer from ``params``: its history and
    gathered state after ``steps`` steps (after a restore first, when
    asked)."""
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig
    tc = TrainConfig(seq_len=seq, global_batch=batch, num_steps=steps,
                     log_every=0, ckpt_every=0, ckpt_dir=ckpt_dir)
    tr = Trainer(_cfg(arch, dtype), tc, hp=OptHParams(**HP), device="cpu")
    load_params(tr, params)
    out = {}
    if restore:
        out["restored"] = tr.maybe_restore()
        out["after_restore"] = gathered(tr)
    for _ in range(steps):
        tr.train_one()
    out.update(history=tr.history, state=gathered(tr))
    return out


def close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def train_each(rank, world, job_path):
    """:func:`train` for each job of ``job["jobs"]`` in turn, in the same
    ranks; rank 0 writes the list of results."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    outs = [_train(one) for one in job["jobs"]]
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(outs, f)


def vocab_parallel(rank, world, job_path):
    """The embedding lookup and the loss with the vocab sharded over
    ``model`` on a (2, 2) mesh, against the one-device functions: values
    and gradients, and the names of the collectives each issues; rank 0
    writes the largest differences and the names."""
    from types import SimpleNamespace
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import full, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    table, tokens, ct, logits, labels = (torch.from_numpy(job[k]) for k in (
        "table", "tokens", "ct", "logits", "labels"))
    vocab = job["vocab"]

    def dist_(t, pl, grad=False):
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return d.requires_grad_(True) if grad else d

    t1 = table.clone().requires_grad_(True)
    x1 = L.embed_apply(SimpleNamespace(tok=t1), tokens, torch.float32)
    (x1 * ct).sum().backward()
    l1 = logits.clone().requires_grad_(True)
    loss1 = L.cross_entropy_loss(l1, labels, vocab)
    loss1.backward()

    rows = (Shard(0), Replicate())
    t2 = dist_(table, (Replicate(), Shard(0)), grad=True)
    l2 = dist_(logits, (Shard(0), Shard(2)), grad=True)
    with use_mesh(mesh):
        with CommDebugMode() as embed_comm:
            x2 = L.embed_apply(SimpleNamespace(tok=t2), dist_(tokens, rows),
                               torch.float32)
            (x2 * dist_(ct, rows)).sum().backward()
        with CommDebugMode() as loss_comm:
            loss2 = L.cross_entropy_loss(l2, dist_(labels, rows), vocab)
            loss2.backward()
    out = {"x": float((full(x2) - x1).abs().max()),
           "table_grad": float((full(t2.grad) - t1.grad).abs().max()),
           "loss": float((full(loss2) - loss1).abs()),
           "logits_grad": float((full(l2.grad) - l1.grad).abs().max()),
           "x_placements": tuple(x2.placements),
           "embed_comms": sorted(str(k) for k in
                                 embed_comm.get_comm_counts()),
           "loss_comms": sorted(str(k) for k in loss_comm.get_comm_counts())}
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(out, f)

"""Rank-side code of the port's multi-rank CPU tests: each function runs in
one ``gloo`` rank started by ``repro_torch.launch.mesh.spawn`` (spawned
processes import it from this directory) and reads and writes its inputs
and results as pickles, rank 0 writing."""
import contextlib
import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist


def _cfg(arch, dtype, seq_parallel=False):
    from repro_torch.configs import base as CB
    return dataclasses.replace(CB.get_config(arch, smoke=True), dtype=dtype,
                               seq_parallel=seq_parallel)


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
    cfg = _cfg(job["arch"], job["dtype"], job.get("seq_parallel", False))
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
    with _seq_shard_layouts() as layouts:
        for _ in range(job["steps"]):
            tr.train_one()
    if job.get("ckpt_dir"):
        tr.save()
    out.update(history=tr.history, state=gathered(tr),
               world=dist.get_world_size(), seq_shard_layouts=layouts)
    return out


@contextlib.contextmanager
def _seq_shard_layouts():
    """Collect the placements the blocks' ``seq_shard`` constraints give
    (the sequence-parallel residual stream; none unless ``seq_parallel``)
    while the block is open."""
    from repro_torch.models import transformer as TM
    seen = set()
    real = TM.constrain

    def recording(x, *logical):
        y = real(x, *logical)
        if "seq_shard" in logical and hasattr(y, "placements"):
            seen.add(tuple(y.placements))
        return y

    TM.constrain = recording
    try:
        yield seen
    finally:
        TM.constrain = real


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
# serving on a mesh (tests/test_torch_mesh_serve.py)
# ---------------------------------------------------------------------------

# the bf16 decode-step bar of tests/test_torch_engine.py
BF16_BAR = 2e-2


def _serve_model(arch, named):
    """The port's bf16-config SMOKE model holding the whole tensors
    ``named`` (port names -> numpy)."""
    from repro_torch.models import model as M
    cfg = _cfg(arch, "bfloat16")
    model = M.build(cfg, device="meta")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in named.items()}, assign=True)
    return cfg, model


def _engine_run(cfg, model, mode, mesh, job, eos=None):
    """``job``'s prompts through one engine: (outputs, uids in completion
    order, (waves, decode steps, prefill tokens, generated tokens))."""
    from repro_torch.serve.engine import Engine
    eng = Engine(cfg, model, batch_slots=job["slots"],
                 max_len=job["max_len"], mesh=mesh, mode=mode)
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(job["prompts"], job["new"])]
    done = eng.run()
    s = eng.stats
    return ([r.output for r in reqs], [r.uid for r in done],
            (s.waves, s.decode_steps, s.prefill_tokens, s.generated_tokens))


def fed(prompts, slots, mode, i):
    """The tokens request ``i`` is fed before its first output: its prompt,
    left-padded with 0 to its wave's longest prompt in wave mode."""
    if mode == "continuous":
        return list(prompts[i])
    lo = i - i % slots
    wave = prompts[lo:lo + slots]
    return [0] * (max(map(len, wave)) - len(prompts[i])) + list(prompts[i])


def mesh_logits(cfg, model, seq, mesh, job, mode):
    """The bf16 logits (whole, float32) after ``seq``, fed one token at a
    time through the decode step on ``mesh`` as the engine feeds a slot,
    in a cache of the engine's slots and length with every slot fed
    ``seq``, so that each rank computes its rows at the engine's local
    shapes (per-slot lengths in continuous mode, one in wave mode). A
    collective: every rank calls it."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    B = job["slots"]
    cache = M.init_cache(cfg, B, job["max_len"], device="cpu")
    with SH.use_mesh(mesh), torch.no_grad():
        for t, tok in enumerate(seq):
            cur = torch.full((B,) if mode == "continuous" else (), t,
                             dtype=torch.int32)
            args, _ = ST.place_decode_args(
                cfg, mesh, model, cache,
                torch.full((B, 1), tok, dtype=torch.int32), cur)
            model, cache, tokens, cur_len = args
            logits, cache = M.decode_step(model, cfg, cache, tokens, cur_len)
        return SH.full(logits)[0, -1].float()


def partings(cfg, model, mesh, job, mode, got, want):
    """Where each request's tokens ``got`` (the mesh run's) first part from
    ``want``: (request, place, got token, wanted token, the mesh run's
    logit gap between them, the bar 2 x BF16_BAR x max |logit|), or for a
    request whose tokens are all equal, None; a length mismatch gives
    (request, -1, ...)."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            out.append(None)
            continue
        k = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if k is None:
            out.append((i, -1, len(g), len(w), 0.0, 0.0))
            continue
        lg = mesh_logits(cfg, model, fed(job["prompts"], job["slots"], mode,
                                         i) + g[:k], mesh, job, mode)
        out.append((i, k, g[k], w[k], float(lg[g[k]] - lg[w[k]]),
                    2 * BF16_BAR * float(lg.abs().max())))
    return out


def _serve_case(case, mesh, job):
    """One family in both modes on ``mesh``: the mesh engine, the
    ``mesh=None`` engine from the same params, where the tokens part from
    it (and from the reference's, when the case carries them), every
    rank's outputs, and the cache's placements before and after a step."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    cfg, model = _serve_model(case["arch"], case["params"])
    placed, _ = ST.place_model(cfg, mesh, M.cast(model, cfg))
    out = {"arch": case["arch"], "modes": {}}
    for mode in ("continuous", "wave"):
        got = _engine_run(cfg, model, mode, mesh, job)
        one = _engine_run(cfg, model, mode, None, job)
        ranks_ = [None] * dist.get_world_size()
        dist.all_gather_object(ranks_, got)
        rec = {"mesh": got, "none": one, "every_rank": ranks_,
               "vs_none": partings(cfg, placed, mesh, job, mode, got[0],
                                   one[0])}
        out["modes"][mode] = rec
    B = job["slots"]
    cache = M.init_cache(cfg, B, job["max_len"], device="cpu")
    with SH.use_mesh(mesh), torch.no_grad():
        args, _ = ST.place_decode_args(
            cfg, mesh, placed, cache, torch.ones((B, 1), dtype=torch.int32),
            torch.arange(B, dtype=torch.int32) * 7)
        _, new = ST.make_decode_step(cfg)(*args)
    out["cache_placements"] = {k: (tuple(args[1][k].placements),
                                   tuple(new[k].placements)) for k in new}
    return out


def _decode_attention_cases(mesh):
    """``decode_attention`` on a (4, 32) cache whose slots are split over
    ``data`` and sequence over ``model`` (16 positions a rank), per-slot
    lengths falling in either rank's half and a scalar one, float32 and
    bfloat16, against the function on the whole tensors: the largest
    difference, max |out|, and the collectives each issued."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import full, use_mesh
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    B, S, H, KV, hd = 4, 32, 4, 2, 16
    q0, k0, v0 = (torch.randn(s, generator=g) for s in (
        (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, lens in (("per slot", torch.tensor([3, 16, 17, 32],
                                                     dtype=torch.int32)),
                           ("scalar", torch.tensor(21, dtype=torch.int32))):
            q, k, v = (t.to(dtype) for t in (q0, k0, v0))
            want = L.decode_attention(q, k, v, lens)
            cache_pl = (Shard(0), Shard(1))
            dq = distribute_tensor(q, mesh, (Shard(0), Replicate()),
                                   src_data_rank=None)
            dk, dv = (distribute_tensor(t, mesh, cache_pl,
                                        src_data_rank=None) for t in (k, v))
            with use_mesh(mesh), CommDebugMode() as comm:
                got = L.decode_attention(dq, dk, dv, lens)
            whole = full(got)
            out[(str(dtype).split(".")[-1], name)] = {
                "err": float((whole.float() - want.float()).abs().max()),
                "max_abs": float(want.float().abs().max()),
                "dtype": str(whole.dtype), "placements": tuple(
                    got.placements),
                "comms": {str(c): n for c, n in
                          comm.get_comm_counts().items()}}
    return out


def _reset_cases(mesh, archs):
    """``Engine._reset_slot`` of slots 1 and 2 on each family's 4-slot cache
    placed on ``mesh`` (slots over ``data``: slot 1 on the first data
    rank, slot 2 on the second), filled with the same random values on
    every rank: whether each whole tensor is the fill with that slot
    zeroed, whether this rank's shard changed exactly where it holds the
    slot, and the collectives the reset issued."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import (full, local, local_index,
                                                  use_mesh)
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    out = {}
    for arch in archs:
        cfg = _cfg(arch, "bfloat16")
        model = M.init(cfg, seed=0, device="cpu")
        eng = Engine(cfg, model, batch_slots=4, max_len=32, mesh=mesh)
        dims = M.cache_batch_dims(cfg)
        g = torch.Generator().manual_seed(1)
        cache = M.init_cache(cfg, 4, 32, device="cpu")
        for t in cache.values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype) + 3)
        want = {k: t.clone() for k, t in cache.items()}
        with use_mesh(mesh):
            (_, cache, _, _), _ = ST.place_decode_args(
                cfg, mesh, eng.model, cache,
                torch.zeros((4, 1), dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32))
        rec = {"whole": True, "local": True, "comms": {},
               "sharded": all(any(p.is_shard(dims[k]) for p in t.placements)
                              for k, t in cache.items())}
        for slot in (1, 2):
            before = {k: local(t).clone() for k, t in cache.items()}
            with CommDebugMode() as comm:
                eng._reset_slot(cache, slot)
            rec["comms"].update({str(c): n for c, n in
                                 comm.get_comm_counts().items()})
            for k, t in cache.items():
                want[k].select(dims[k], slot).zero_()
                rec["whole"] &= torch.equal(full(t), want[k])
                changed = not torch.equal(local(t), before[k])
                rec["local"] &= changed == (local_index(t, dims[k], slot)
                                            is not None)
        out[arch] = rec
    return out


def _vs_reference(job, mesh, out):
    """Wait for the reference's runs (``job["ref_out"]``, written by a
    process started beside the ranks; rank 0 reads it and hands it on),
    then add each such case's reference runs and where the mesh run's
    tokens part from them."""
    import os
    import time
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    box = [None]
    if dist.get_rank() == 0:
        t0 = time.time()
        while not os.path.exists(job["ref_out"]):
            if time.time() - t0 > job.get("ref_wait_s", 240):
                raise TimeoutError(f"no {job['ref_out']}")
            time.sleep(0.2)
        with open(job["ref_out"], "rb") as f:
            box[0] = pickle.load(f)
    dist.broadcast_object_list(box, src=0)
    out["reference_devices"] = box[0]["devices"]
    for case, res in zip(job["cases"], out["cases"]):
        runs = box[0]["cases"].get(case["arch"])
        if runs is None:
            continue
        cfg, model = _serve_model(case["arch"], case["params"])
        placed, _ = ST.place_model(cfg, mesh, M.cast(model, cfg))
        for mode, rec in res["modes"].items():
            rec["ref"] = runs[mode]
            rec["vs_ref"] = partings(cfg, placed, mesh, job, mode,
                                     rec["mesh"][0], runs[mode][0])


def serve_each(rank, world, job_path):
    """Serving on a (2, 2) ``("data", "model")`` mesh: each case of
    ``job["cases"]`` through the mesh engine and the ``mesh=None`` one
    (:func:`_serve_case`), then ``decode_attention`` on a seq-sharded
    cache and ``_reset_slot`` on batch-sharded caches; rank 0 writes."""
    from repro_torch.launch.mesh import make_mesh
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"cases": [_serve_case(c, mesh, job) for c in job["cases"]],
           "decode_attention": _decode_attention_cases(mesh),
           "reset": _reset_cases(mesh, [c["arch"] for c in job["cases"]]),
           "world": world}
    if job.get("ref_out"):
        _vs_reference(job, mesh, out)
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(out, f)


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
                          dtype=job["dtype"],
                          seq_parallel=job.get("seq_parallel", False))
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


def reference_train(repo, tmp, arch, seq, steps=3, batch=4, dtype="float32",
                    seq_parallel=False):
    """The reference ``Trainer`` on the Auto-axis (2, 2) mesh of 4 forced
    host devices: its initial and final parameter trees and history."""
    job, out = tmp / f"jax_{arch}.pkl", tmp / f"jax_{arch}_out.pkl"
    with open(job, "wb") as f:
        pickle.dump(dict(arch=arch, dtype=dtype, seq=seq, batch=batch,
                         steps=steps, hp=HP, seq_parallel=seq_parallel), f)
    _run([_JAX_TRAIN, str(job), str(out)], repo)
    with open(out, "rb") as f:
        return pickle.load(f)

_JAX_SERVE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys, pickle, dataclasses
sys.path.insert(0, "src")
import jax, numpy as np
from repro.configs import base as CB
from repro.models import model as JM
from repro.serve.engine import Engine
job = pickle.load(open(sys.argv[1], "rb"))
# Auto axes, as the reference's trainer needs under jax 0.9.0
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
out = {"devices": jax.device_count(), "cases": {}}
for arch, params in job["params"].items():
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="bfloat16")
    runs = {}
    for mode in ("continuous", "wave"):
        eng = Engine(cfg, params, batch_slots=job["slots"],
                     max_len=job["max_len"], mesh=mesh, mode=mode)
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(job["prompts"], job["new"])]
        done = eng.run()
        s = eng.stats
        runs[mode] = ([r.output for r in reqs], [r.uid for r in done],
                      (s.waves, s.decode_steps, s.prefill_tokens,
                       s.generated_tokens))
    out["cases"][arch] = runs
pickle.dump(out, open(sys.argv[2] + ".part", "wb"))
os.replace(sys.argv[2] + ".part", sys.argv[2])   # whole when it appears
"""


def reference_params(arch, seed=0):
    """The reference's bf16-config SMOKE params from
    ``jax.random.PRNGKey(seed)``, as a numpy tree."""
    import jax
    from repro.configs import base as CB
    from repro.models import model as JM
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="bfloat16")
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed),
                                            cfg)[0])


def start_reference_serve(repo, tmp, job):
    """Start the reference's ``Engine`` on the Auto-axis (2, 2) mesh of 4
    forced host devices, both modes, for each arch of ``job["params"]``
    (arch -> numpy tree) in a subprocess; :func:`finish` returns each
    arch's mode -> (outputs, completion order, stats)."""
    path, out = tmp / "jax_serve.pkl", tmp / "jax_serve_out.pkl"
    with open(path, "wb") as f:
        pickle.dump(job, f)
    return _start([_JAX_SERVE, str(path), str(out)], repo), out


def start_ranks(repo, tmp, fn: str, world: int, job: dict, name: str):
    """:func:`ranks`, started: :func:`finish` returns what rank 0 wrote."""
    path, out = tmp / f"{name}.pkl", tmp / f"{name}_out.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(job, out=str(out)), f)
    return _start([_TORCH_RANKS, fn, str(world), str(path)], repo), out


def _start(argv, cwd):
    import subprocess
    import sys
    return subprocess.Popen([sys.executable, "-c", *argv], cwd=cwd,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def finish(started, timeout=300):
    proc, out = started
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
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
               restore=False, seq_parallel=False):
    """The port's ``mesh=None`` trainer from ``params``: its history and
    gathered state after ``steps`` steps (after a restore first, when
    asked)."""
    from repro_torch.train.optimizer import OptHParams
    from repro_torch.train.trainer import Trainer, TrainConfig
    tc = TrainConfig(seq_len=seq, global_batch=batch, num_steps=steps,
                     log_every=0, ckpt_every=0, ckpt_dir=ckpt_dir)
    tr = Trainer(_cfg(arch, dtype, seq_parallel), tc, hp=OptHParams(**HP),
                 device="cpu")
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

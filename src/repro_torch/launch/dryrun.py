"""Multi-pod dry-run, ported from ``repro.launch.dryrun``: trace every
(architecture x input shape) cell on the production meshes without
allocating, and record its per-device cost, memory and roofline.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell's step (``launch.steps.build_cell``) runs once under
``FakeTensorMode`` on a fake production mesh (``launch.mesh.
make_fake_mesh``: (16, 16), or (2, 16, 16) multi-pod): its parameters,
optimizer state and batch (or decode cache) are ``DTensor``s of fake
tensors with the reference's placements, so nothing is allocated and no
kernel launches. The aten-op counter (``analysis.opcount``) counts the
trace per device, where the reference compiles the module and walks its
HLO. ``--device`` (default ``cuda``) is the fake tensors' device; ``cpu``
traces the same ops off the card, but for the collectives DTensor picks
per device type (``gloo`` has no all-to-all).

``--one-card CONFIG_JSON`` predicts instead the memory of one card's
train step on its own, with no mesh (:func:`one_card_train`): a JSON file
holding ``ModelConfig``'s fields under ``model`` and ``OptHParams``'s
under ``optimizer`` (a benchmark configuration's file), on ``--batch`` x
``--seq`` tokens; it prints one JSON record.

Each cell's record goes to ``<out>/<arch>_<shape>_<mesh>.json`` (default
``results/dryrun_torch``): status, timings (``build_s``, ``trace_s``),
``memory_analysis`` (``argument_size_in_bytes``: this rank's shards of the
params, optimizer state and batch or cache, exactly;
``temp_size_in_bytes``: the peak of the storages the step created, the
counter's own count), ``hlo_summary`` (the counter's ``CostSummary``) and
``roofline`` (``analysis.roofline``, H100 constants).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import roofline as RL
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import base as CB
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (modules'
    parameters, dicts, lists and tuples of tensors)."""
    if isinstance(tree, torch.nn.Module):
        return local_bytes(list(tree.parameters()))
    if isinstance(tree, dict):
        return local_bytes(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        t = SH.local(tree)
        return t.numel() * t.element_size()
    return 0


def count_step(spec: ST.DryrunSpec, mesh) -> OpCounter:
    """``spec.fn(*spec.args)`` once on ``mesh`` under the op counter (inside
    the caller's ``FakeTensorMode`` for a trace)."""
    counter = OpCounter()
    with SH.use_mesh(mesh), counter:
        spec.fn(*spec.args)
    return counter


def one_card_train(cfg: CB.ModelConfig, hp: OPT.OptHParams,
                   global_batch: int, seq_len: int, *,
                   device="cuda") -> dict:
    """The predicted memory of one train step of ``cfg`` on one card, with
    no mesh: the step (``launch.steps.make_train_step``, as ``Trainer``
    runs it) traced once under ``FakeTensorMode`` and the op counter.
    ``argument_bytes`` are the parameters, both Adam moments and the batch;
    ``temp_bytes`` the peak of the storages the step created (gradients,
    activations, the kernels' recomputes); ``predicted_bytes`` their sum,
    to hold against ``torch.cuda.max_memory_allocated`` (which the
    allocator's rounding and the kernels' own scratch can lift above it)."""
    shape = CB.ShapeConfig("one_card", seq_len, global_batch, "train")
    dev = torch.device(device)
    t0 = time.time()
    with FakeTensorMode():
        model, _ = M.abstract_init(cfg, device=dev)
        model.requires_grad_(True)
        opt = OPT.init_state(dict(model.named_parameters()), hp)
        batch, _ = ST.batch_specs(cfg, shape, with_labels=True, device=dev)
        args = local_bytes((model, opt, batch))
        counter = OpCounter()
        with counter:
            ST.make_train_step(cfg, hp)(model, opt, batch)
    summary = counter.summary
    return {"name": cfg.name, "batch": global_batch, "seq": seq_len,
            "params": cfg.param_count(), "state_dtype": hp.state_dtype,
            "argument_bytes": args, "temp_bytes": counter.peak_bytes,
            "predicted_bytes": args + counter.peak_bytes,
            "flops": summary.flops, "hbm_bytes": summary.hbm_bytes,
            "flash_nodes": counter.kernel_nodes("flash_attention"),
            "trace_s": round(time.time() - t0, 2)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, *, device="cuda",
             verbose: bool = True) -> dict:
    cfg = CB.get_config(arch)
    shape = CB.get_shape(shape_name)
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{CB.canonical_arch(arch)}_{shape_name}_{mesh_name}"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                fake=True)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "n_devices": mesh.size(), "device": str(mesh.device_type),
              "status": "ok"}
    try:
        with FakeTensorMode():
            spec = ST.build_cell(cfg, shape, mesh)
            t_build = time.time() - t0
            counter = count_step(spec, mesh)
            t_trace = time.time() - t0 - t_build
        mem = {"argument_size_in_bytes": local_bytes(spec.args),
               "temp_size_in_bytes": counter.peak_bytes}
        summary = counter.summary
        rl = RL.Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name,
            n_devices=mesh.size(),
            hlo_flops_per_dev=summary.flops,
            hlo_bytes_per_dev=summary.hbm_bytes,
            collective_bytes_per_dev=summary.collective_bytes,
            model_flops_global=RL.model_flops(cfg, shape),
            per_device_memory=float(mem["argument_size_in_bytes"]
                                    + mem["temp_size_in_bytes"]),
        )
        record.update({
            "build_s": round(t_build, 2),
            "trace_s": round(t_trace, 2),
            "memory_analysis": mem,
            "hlo_summary": summary.to_json(),
            "roofline": rl.to_json(),
        })
        if verbose:
            gb = 1 << 30
            print(f"[{tag}] ok build={t_build:.1f}s trace={t_trace:.1f}s "
                  f"arg+temp={rl.per_device_memory/gb:.2f}GiB/dev "
                  f"t_comp={rl.t_compute*1e3:.2f}ms t_mem={rl.t_memory*1e3:.2f}ms "
                  f"t_coll={rl.t_collective*1e3:.2f}ms "
                  f"bottleneck={rl.bottleneck} "
                  f"roofline_frac={rl.roofline_fraction:.3f}",
                  flush=True)
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{tag}] FAILED: {type(e).__name__}: {str(e)[:400]}",
                  flush=True)

    out_dir.mkdir(parents=True, exist_ok=True)
    # strip the big per-collective list for the saved summary if huge
    rec = dict(record)
    hs = rec.get("hlo_summary")
    if hs and len(hs.get("collectives", [])) > 200:
        hs = dict(hs, collectives=hs["collectives"][:200])
        rec["hlo_summary"] = hs
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda or cpu)")
    ap.add_argument("--one-card", metavar="CONFIG_JSON", default=None,
                    help="predict one card's train step of this "
                         "configuration (model and optimizer sections)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)

    if args.one_card:
        conf = json.loads(pathlib.Path(args.one_card).read_text())
        cfg = CB.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in conf["model"].items()})
        rec = one_card_train(cfg, OPT.OptHParams(**conf["optimizer"]),
                             args.batch, args.seq, device=args.device)
        print(json.dumps(rec), flush=True)
        return 0

    out_dir = pathlib.Path(args.out)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.all:
        cells = CB.cells()
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = [args.shape] if args.shape else [
            s for (a, s) in CB.cells() if a == CB.canonical_arch(args.arch)]
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    for arch, shape_name in cells:
        for multi in meshes:
            tag = (f"{CB.canonical_arch(arch)}_{shape_name}_"
                   f"{'multi' if multi else 'single'}")
            if args.skip_existing and (out_dir / f"{tag}.json").exists():
                prev = json.loads((out_dir / f"{tag}.json").read_text())
                if prev.get("status") == "ok":
                    print(f"[{tag}] skip (exists)", flush=True)
                    continue
            rec = run_cell(arch, shape_name, multi, out_dir,
                           device=args.device)
            failures += rec["status"] != "ok"
    print(f"dryrun complete: {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

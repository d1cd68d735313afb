"""One run of a training cell, from set-up to verdict.

1. Set-up: the program (``repro_torch``) builds its ``Trainer`` for the
   cell's configuration and traffic; the benchmark loads its own seeded
   weights into the model and feeds the trainer its own seeded batches
   (``lib/traffic.py``); the trainer's first ``compare_steps`` steps,
   through ``Trainer.train_one`` as in the window, warm every shape up and
   give the program's readings (``reference/train.py`` says which).
2. The window: ``Trainer.train_one`` in a loop, whole optimizer steps,
   until ``seconds`` have passed; the memory peak is the window's.
3. With ``trace``: a few more steps under the profiler.
4. The program's state is freed and the reference follows the same first
   steps from the same weights and batches; the comparison decides
   ``correct`` (``lib/compare.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Callable, Optional

from perfbench.lib import catalog, compare, tracing
from perfbench.lib.traffic import TokenBatches, rows_differ
from perfbench.reference import common as C
from perfbench.reference import train as RT


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads."""
    model: dict                    # the configuration's model section
    traffic: dict
    itemsize: int                  # bytes of an activation element
    window_steps: int
    window_s: float
    trace: Optional[tracing.Trace]


def model_config(model: dict):
    """The program's ``ModelConfig`` of a configuration's model section."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items()})


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_weights(torch, model, m: dict, seed: int, device) -> None:
    """The benchmark's weights of ``seed`` into the program's model, one
    group of parameters at a time."""
    specs = RT.family(m["family"]).param_specs(m)
    params = dict(model.named_parameters())
    names = {s[0] for s in specs}
    if names != set(params):
        raise ValueError(f"the program's parameters are not the reference's: "
                         f"{sorted(names ^ set(params))[:6]}")
    with torch.no_grad():
        for gname in C.groups(specs):
            for name, t in C.init_params(specs, seed, device,
                                         only=(gname,)).items():
                if params[name].shape != t.shape:
                    raise ValueError(f"{name}: the program's shape "
                                     f"{tuple(params[name].shape)}, the "
                                     f"reference's {tuple(t.shape)}")
                params[name].copy_(t)


def build_program(torch, conf: dict, traffic: dict, seed: int, device):
    """The program's trainer with the benchmark's weights and batches."""
    from repro_torch.train import optimizer as OPT
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = model_config(conf["model"])
    tc = TrainConfig(seq_len=traffic["seq_len"],
                     global_batch=traffic["global_batch"],
                     microbatches=traffic["microbatches"], num_steps=1 << 62,
                     log_every=0, ckpt_every=0, ckpt_dir=None, seed=seed)
    data = TokenBatches(traffic, cfg.vocab_size, seed)
    trainer = Trainer(cfg, tc, OPT.OptHParams(**conf["optimizer"]),
                      data=data, device=device)
    load_weights(torch, trainer.model, conf["model"], seed, device)
    return trainer


def program_readings(torch, trainer, conf: dict, seed: int, steps: int,
                     device) -> dict:
    """The trainer's first ``steps`` steps through ``train_one`` and the
    readings the reference's are compared with."""
    b1 = conf["optimizer"]["b1"]
    specs = RT.family(conf["model"]["family"]).param_specs(conf["model"])
    out = {"loss": [], "grad_norm": []}
    for i in range(steps):
        if not rows_differ(trainer.data.batch_at(trainer.data.index)):
            raise ValueError(f"batch {trainer.data.index} repeats a sequence")
        met = trainer.train_one()
        out["loss"].append(met["loss"])
        out["grad_norm"].append(met["grad_norm"])
        if i == 0:
            with torch.no_grad():
                out["grad"] = {
                    k: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                    for k, m in trainer.opt_state["m"].items()}
    with torch.no_grad():
        out["update"] = RT.norms_by_group(specs, seed, trainer.params, device)
    return out


def reference_readings(conf: dict, traffic: dict, seed: int, steps: int,
                       device, *, prec: str = "float32",
                       rows: str = "all") -> dict:
    data = TokenBatches(traffic, conf["model"]["vocab_size"], seed)
    return RT.follow(conf["model"], conf["optimizer"],
                     [data.batch_at(i) for i in range(steps)], seed,
                     microbatches=traffic["microbatches"], device=device,
                     prec=prec, rows=rows)


def free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", setup_clock: Callable[[], float] = None,
        conf: dict = None, traffic: dict = None, limits: dict = None,
        log=None) -> dict:
    """One run of ``cell``: the result's fields (without ``device``'s
    platform entries) and the compared numbers. ``conf``, ``traffic`` and
    ``limits`` override the cell's files (the tests' small sizes);
    ``setup_clock()`` gives the seconds since the process started."""
    import torch
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    start = time.perf_counter()
    setup_clock = setup_clock or (lambda: time.perf_counter() - start)
    wl = catalog.workload(cell)
    conf = conf or catalog.config(wl["config"])
    traffic = traffic or catalog.traffic(wl["traffic"])
    limits = limits if limits is not None else catalog.limits(cell)
    steps = traffic["compare_steps"]
    cuda = torch.device(device).type == "cuda"

    log(f"setup: {setup_clock():.3f} s at the start of the cell")
    trainer = build_program(torch, conf, traffic, seed, device)
    log(f"setup: {setup_clock():.3f} s with the trainer built and loaded")
    prog = program_readings(torch, trainer, conf, seed, steps, device)
    log(f"setup: {setup_clock():.3f} s after {steps} first steps; "
        f"program losses {prog['loss']}")

    _sync(torch, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_clock()
    t0 = time.perf_counter()
    n, failed = 0, 0
    while True:
        met = trainer.train_one()
        n += 1
        failed += not math.isfinite(met["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tokens = n * traffic["global_batch"] * traffic["seq_len"]
    log(f"window: {n} steps in {window_s:.3f} s, peak {peak} B")

    tr = None
    if trace:
        k = traffic["trace_steps"]
        tr = tracing.capture(torch, lambda: [trainer.train_one()
                                             for _ in range(k)], k)
    del trainer, met
    free(torch)

    t1 = time.perf_counter()
    ref = reference_readings(conf, traffic, seed, steps, device)
    log(f"reference: {time.perf_counter() - t1:.3f} s, losses {ref['loss']}")
    nums = compare.numbers(prog, ref)
    ok, checks = compare.verdict(nums, limits)
    record = RunRecord(model=conf["model"], traffic=traffic,
                       itemsize=getattr(torch, conf["model"]["dtype"]).itemsize,
                       window_steps=n, window_s=window_s, trace=tr)
    return {"correct": ok and failed == 0, "attempted": n, "failed": failed,
            "setup_s": setup_s, "tokens_s": tokens / window_s,
            "peak_bytes": peak, "record": record, "checks": checks}

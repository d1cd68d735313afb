"""The port's dry-run (``repro_torch.launch.dryrun``) and its analysis
(``repro_torch.analysis.{opcount,roofline}``), on the CPU.

- ``roofline.model_flops`` equals the reference's bit for bit for every
  cell, and ``Roofline``'s terms follow from the H100 constants.
- The aten-op counter gives the twins of the reference's HLO tests
  (``tests/test_sharding.py``): a matmul's FLOPs, a loop's 5x, the ring
  all-reduce's bytes; and per-device counts on a (16, 16) mesh.
- The twin of ``tests/test_dryrun_smoke.py``: llama3.2-1b SMOKE traced on
  a fake (4, 2) ``cpu`` mesh for train, prefill and decode, the kernel
  nodes counted against the model's layers, and the same steps run for
  real on that mesh counting the same FLOPs and bytes.
- The LM kernels' registered ops equal their plain versions bit for bit.
- ``abstract_init``, ``abstract_cache`` (the cache's logical axes against
  the reference's ``init_cache``) and ``optimizer.state_axes``.

Every process group is made in a subprocess (each under 120 s): the suite
runs files on shared workers, and a group left behind would leak into the
next file. The counts are held against analytic values, not the
reference's dry-run, which fails under jax 0.9.0.
"""
import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import roofline as RRL
from repro.configs import base as RCB
from repro.models import model as RM
from repro_torch.analysis import roofline as RL
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import base as CB
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.train import optimizer as OPT

ROOT = pathlib.Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", RCB.cells(include_skipped=True))
def test_model_flops_equals_reference_bit_for_bit(arch, shape):
    got = RL.model_flops(CB.get_config(arch), CB.get_shape(shape))
    want = RRL.model_flops(RCB.get_config(arch), RCB.get_shape(shape))
    assert got == want and type(got) is type(want)


def test_roofline_terms_follow_from_h100_constants():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 50e9)
    rl = RL.Roofline(arch="a", shape="s", mesh="single", n_devices=256,
                     hlo_flops_per_dev=2e12, hlo_bytes_per_dev=1e10,
                     collective_bytes_per_dev=5e7, model_flops_global=2e14,
                     per_device_memory=1.0)
    assert rl.t_compute == 2e12 / 989e12
    assert rl.t_memory == 1e10 / 3.35e12
    assert rl.t_collective == 5e7 / 50e9
    assert rl.bottleneck == "memory"
    assert rl.step_time_lower_bound == rl.t_memory
    assert rl.useful_flops_ratio == 2e14 / (2e12 * 256)
    assert rl.roofline_fraction == (2e14 / 256) / (rl.t_memory * 989e12)
    j = rl.to_json()
    assert j["t_compute_s"] == rl.t_compute and j["bottleneck"] == "memory"
    assert set(j) == set(RRL.Roofline(**{
        k: getattr(rl, k) for k in ("arch", "shape", "mesh", "n_devices",
                                    "hlo_flops_per_dev", "hlo_bytes_per_dev",
                                    "collective_bytes_per_dev",
                                    "model_flops_global",
                                    "per_device_memory")}).to_json())


# ---------------------------------------------------------------------------
# the counter, in this process (no process group)
# ---------------------------------------------------------------------------


def test_counter_matmul_flops_and_bytes():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    with OpCounter() as c:
        a @ b
    s = c.summary
    assert s.flops == 2 * 64 * 32 * 16
    assert s.hbm_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert s.by_opcode["aten.mm"]["count"] == 1


def test_counter_counts_a_loop_of_five_matmuls_five_times():
    a, b = torch.zeros(8, 8), torch.zeros(8, 8)
    with OpCounter() as one:
        a @ b
    with OpCounter() as five:
        x = a
        for _ in range(5):
            x = x @ b
    assert five.summary.flops == 5 * one.summary.flops == 5 * 2 * 8 * 8 * 8


def test_counter_views_are_free_and_elementwise_counts_elements():
    x = torch.zeros(4, 6)
    with OpCounter() as c:
        y = x.view(6, 4).t().transpose(0, 1)
        z = torch.exp(y) + 1.0
    s = c.summary
    assert s.by_opcode["aten.view"]["bytes"] == 0
    assert s.by_opcode["aten.exp"]["flops"] == 24
    assert s.by_opcode["aten.add"]["flops"] == 24
    assert s.flops == 48 and s.hbm_bytes == 4 * 24 * 4
    assert z.shape == (6, 4)


def test_counter_peak_temporaries():
    x = torch.zeros(1024)
    with OpCounter() as c:
        y = x + 1          # 4 KiB live
        z = y * 2          # 8 KiB live
        del y              # 4 KiB
        w = z + 3          # 8 KiB again
    assert c.peak_bytes == 2 * 4096
    del z, w
    assert c.live_bytes == 0


def test_counter_counts_kernel_ops_as_their_work():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 16), np.float32))
    X = torch.from_numpy(rng.standard_normal((1, 64, 2, 16), np.float32))
    A = -torch.from_numpy(rng.random((1, 64, 2), np.float32))
    Bc = torch.from_numpy(rng.standard_normal((1, 64, 16), np.float32))
    with OpCounter() as c:
        fa.flash_attention(q, k, k)
        ssd.ssd_scan(X, A, Bc, Bc, chunk=32)
    s = c.summary
    assert c.kernel_nodes("flash_attention") == 1
    assert c.kernel_nodes("ssd_scan") == 1
    fb, ff = fa.work(q, k)
    sb, sf = ssd.work(X, Bc, 32)
    assert s.flops == ff + sf and s.hbm_bytes == fb + sb
    assert set(s.by_opcode) == {"repro_torch.flash_attention",
                                "repro_torch.ssd_scan"}


@pytest.mark.parametrize("state_dtype,per_element", [
    (torch.float32, 32), (torch.bfloat16, 24)])
def test_counter_counts_adamw_ops_as_their_work(state_dtype, per_element):
    """The optimizer's two kernel ops: the norm reads each gradient once (4
    B an element), the update reads p, g, m, v and writes p, m, v once (28
    B with float32 moments, 20 with bfloat16)."""
    rng = np.random.default_rng(3)
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((64, 48), (5,))]
    gs = [torch.ones_like(p) for p in ps]
    ms = [torch.zeros_like(p, dtype=state_dtype) for p in ps]
    vs = [torch.zeros_like(p, dtype=state_dtype) for p in ps]
    one = torch.tensor(1.0)
    with OpCounter() as c:
        torch.ops.repro_torch.adamw_sumsq(gs, [1, 1])
        torch.ops.repro_torch.adamw_update(ps, gs, ms, vs, [True, False],
                                           one, one, one, one, 0.9, 0.95,
                                           1e-8, 0.1)
    n = 64 * 48 + 5
    assert c.kernel_nodes("adamw_sumsq") == 1
    assert c.kernel_nodes("adamw_update") == 1
    assert set(c.summary.by_opcode) == {"repro_torch.adamw_sumsq",
                                        "repro_torch.adamw_update"}
    assert c.summary.hbm_bytes == per_element * n
    assert c.summary.flops == 2 * n + 15 * n + 2 * 64 * 48


# ---------------------------------------------------------------------------
# the LM kernels' registered ops
# ---------------------------------------------------------------------------


def _qkv(dtype, S=80):
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return mk(2, S, 4, 32), mk(2, S, 2, 32), mk(2, S, 2, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_equals_plain_version_bit_for_bit(dtype):
    q, k, v = _qkv(dtype)
    got = torch.ops.repro_torch.flash_attention(q, k, v)
    assert torch.equal(got, flash_attention_ref(q, k, v))
    assert torch.equal(fa.flash_attention(q, k, v), got)
    assert fa.launches["flash_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_op_equals_plain_version_bit_for_bit(dtype):
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((2, 64, 3, 16), np.float32)
                         ).to(dtype)
    A = -torch.from_numpy(rng.random((2, 64, 3), np.float32))
    Bc = torch.from_numpy(rng.standard_normal((2, 64, 16), np.float32)
                          ).to(dtype)
    Cc = torch.from_numpy(rng.standard_normal((2, 64, 16), np.float32)
                          ).to(dtype)
    got = torch.ops.repro_torch.ssd_scan(X, A, Bc, Cc, 16)
    assert torch.equal(got, ssd.ssd_chunked(X, A, Bc, Cc, 16)[0])
    assert torch.equal(ssd.ssd_scan(X, A, Bc, Cc, chunk=16), got)
    assert ssd.launches["ssd_scan"] == 0


def test_kernel_ops_trace_as_one_node_under_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q, k, v = (torch.empty(2, 4096, 32, 64, dtype=torch.bfloat16),
                   torch.empty(2, 4096, 8, 64, dtype=torch.bfloat16),
                   torch.empty(2, 4096, 8, 64, dtype=torch.bfloat16))
        with OpCounter() as c:
            out = fa.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert set(c.summary.by_opcode) == {"repro_torch.flash_attention"}
    assert c.summary.flops == fa.work(q, k)[1]


def test_kernel_entry_on_cpu_tensors_raises_and_torch_skips_the_op():
    q, k, v = _qkv(torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.kernel_forward(q, k, v)
    with OpCounter() as c:
        fa.flash_attention(q, k, v, backend="torch")
    assert c.kernel_nodes("flash_attention") == 0


def _route_case(kernel: str, backend: str) -> dict:
    """Run ``kernel``'s wrapper (with a backward where it has one) and the
    model's call of it under ``backend`` on tensors made here: its kernel
    op nodes, the model's, and the SSD backward's recomputes."""
    grad = dict(requires_grad=True)
    if kernel == "adamw":
        params = {"blocks.0.w": torch.ones(4, 8), "top": torch.ones(8)}
        grads = {k: torch.full_like(p, 0.5) for k, p in params.items()}
        hp = OPT.OptHParams(warmup_steps=2)
        with OpCounter() as c:
            OPT.apply_updates(params, grads, OPT.init_state(params, hp), hp,
                              backend=backend)
        return {"nodes": c.kernel_nodes("adamw_sumsq")
                + c.kernel_nodes("adamw_update")}
    if kernel == "flash_attention":
        q = torch.ones(1, 64, 2, 16, dtype=torch.bfloat16, **grad)
        kv = torch.ones(1, 64, 1, 16, dtype=torch.bfloat16, **grad)
        with OpCounter() as c:
            fa.flash_attention(q, kv, kv, backend=backend).sum().backward()
        with OpCounter() as m:
            L.causal_attention(q, kv, kv, backend=backend)
        return {"nodes": c.kernel_nodes(kernel),
                "model_nodes": m.kernel_nodes(kernel)}
    X = torch.ones(1, 64, 2, 16, dtype=torch.bfloat16, **grad)
    Adt = torch.full((1, 64, 2), -0.5, **grad)
    Bc = torch.ones(1, 64, 16, dtype=torch.bfloat16, **grad)
    ssd.reset_launches()
    with OpCounter() as c:
        ssd.ssd_scan(X, Adt, Bc, Bc, chunk=32,
                     backend=backend).sum().backward()
    with OpCounter() as m:
        SSM.ssd_y(X, Adt, Bc, Bc, 32, backend)
    return {"nodes": c.kernel_nodes(kernel),
            "model_nodes": m.kernel_nodes(kernel),
            "backward_nodes": c.kernel_nodes("ssd_scan_backward"),
            "recomputes": ssd.backward_recomputes["ssd_scan"]}


@pytest.mark.parametrize("backend", ["auto", "torch", "xla"])
@pytest.mark.parametrize("device", ["cpu", "fake"])
@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan", "adamw"])
def test_route_takes_each_implementation_on_each_device(kernel, device,
                                                        backend):
    """``_build.route`` on the CPU, fake tensors standing for the card. A
    wrapper or the optimizer called directly runs its registered op (one
    node; the plain version on the CPU, the card's node in a trace) for
    ``"auto"`` and the plain version, no op, for ``"torch"``. The models
    on CPU tensors under ``"auto"`` run the reference's own functions (no
    op), on fake ones the op. The SSD backward takes its op for bf16 fake
    tensors under ``"auto"`` and recomputes ``ssd_chunked`` everywhere
    else. Any other backend raises."""
    with FakeTensorMode() if device == "fake" else contextlib.nullcontext():
        if backend == "xla":
            with pytest.raises(ValueError, match="unknown backend 'xla'"):
                _route_case(kernel, backend)
            return
        got = _route_case(kernel, backend)
    op, card = backend == "auto", backend == "auto" and device == "fake"
    want = {"nodes": 2 * op if kernel == "adamw" else int(op)}
    if kernel != "adamw":
        want["model_nodes"] = int(card)
    if kernel == "ssd_scan":
        want.update(backward_nodes=int(card), recomputes=int(not card))
    assert got == want


@pytest.mark.cuda
def test_kernel_ops_equal_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v = (t.cuda() for t in _qkv(torch.bfloat16, S=256))
    before = fa.launches["flash_attention"]
    got = torch.ops.repro_torch.flash_attention(q, k, v)
    assert fa.launches["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v)
    assert float((got.float() - want.float()).abs().max()) <= 3e-2
    cpu = torch.ops.repro_torch.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert torch.equal(cpu, flash_attention_ref(q.cpu(), k.cpu(), v.cpu()))


# ---------------------------------------------------------------------------
# abstract init, cache axes, optimizer axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", CB.ARCH_IDS)
def test_abstract_init_is_fake_with_the_built_shapes(arch):
    from torch._subclasses.fake_tensor import is_fake
    cfg = CB.get_config(arch)
    model, axes = M.abstract_init(cfg, device="cpu")
    meta = M.build(cfg, device="meta")
    params = dict(model.named_parameters())
    assert all(is_fake(p) for p in params.values())
    assert {k: (tuple(p.shape), p.dtype) for k, p in params.items()} == {
        k: (tuple(p.shape), p.dtype) for k, p in meta.named_parameters()}
    assert axes == M.param_axes(meta)
    opt = OPT.state_axes(axes)
    assert opt == {"m": axes, "v": axes, "step": ()}


@pytest.mark.parametrize("arch", [a for a in CB.ARCH_IDS
                                  if a in RCB.ARCH_IDS])
def test_abstract_cache_matches_the_reference(arch):
    from torch._subclasses.fake_tensor import is_fake
    cfg = CB.get_config(arch, smoke=True)
    cache, axes = M.abstract_cache(cfg, 4, 96, device="cpu")
    r_cache, r_axes = RM.abstract_cache(RCB.get_config(arch, smoke=True), 4,
                                        96)
    assert axes == r_axes
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in cache.items()} == {
        k: (tuple(s.shape), str(s.dtype)) for k, s in r_cache.items()}
    assert all(is_fake(t) for t in cache.values())
    # init_cache's own value is the same zeros the engine takes
    real = M.init_cache(cfg, 4, 96, device="cpu")
    assert set(real) == set(axes) and all(
        not is_fake(t) and not t.any() for t in real.values())


# ---------------------------------------------------------------------------
# process groups, in one subprocess: the counter under DTensor and the
# SMOKE cells on a fake (4, 2) cpu mesh
# ---------------------------------------------------------------------------

_SCRIPT = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
import torch.distributed._functional_collectives as funcol
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import base as CB
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_fake_mesh

out = {}
mesh = make_fake_mesh((8,), ("x",), device="cpu")
t = torch.zeros(8, 8)
with OpCounter() as c:
    funcol.all_reduce(t, "sum", mesh.get_group())
out["allreduce"] = {"bytes": c.summary.collective_bytes,
                    "groups": [x["group_size"] for x in c.summary.collectives]}

mesh = make_fake_mesh((16, 16), ("data", "model"), device="cpu")
out["sharded_mm"] = {}
for name, pa, pb in [("sharded", (Shard(0), Replicate()),
                      (Replicate(), Shard(1))),
                     ("replicated", (Replicate(), Replicate()),
                      (Replicate(), Replicate()))]:
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(1024, 2048), mesh, pa,
                              src_data_rank=None)
        b = distribute_tensor(torch.empty(2048, 8192), mesh, pb,
                              src_data_rank=None)
        with OpCounter() as c:
            y = a @ b
    out["sharded_mm"][name] = {"flops": c.summary.flops,
                               "coll": c.summary.collective_bytes,
                               "local": list(y.to_local().shape)}

mesh = make_fake_mesh((4, 2), ("data", "model"), device="cpu")
cells = {}
for arch, kinds in (("llama3.2-1b", ("train", "prefill", "decode")),
                    ("mamba2-130m", ("train", "prefill", "decode"))):
    cfg = CB.get_config(arch, smoke=True)
    for kind in kinds:
        shape = CB.ShapeConfig("t", 64, 8, kind)
        with FakeTensorMode():
            spec = ST.build_cell(cfg, shape, mesh)
            c = DR.count_step(spec, mesh)
        rec = {"flops": c.summary.flops, "hbm": c.summary.hbm_bytes,
               "coll": c.summary.collective_bytes, "layers": cfg.num_layers,
               "flash": c.kernel_nodes("flash_attention"),
               "ssd": c.kernel_nodes("ssd_scan"),
               "ssd_backward": c.kernel_nodes("ssd_scan_backward"),
               "norm": [c.kernel_nodes("rms_norm"),
                        c.kernel_nodes("rms_norm_backward")],
               "temp": c.peak_bytes,
               "adamw": [c.kernel_nodes("adamw_sumsq"),
                         c.kernel_nodes("adamw_update")],
               "args": DR.local_bytes(spec.args)}
        if kind != "decode":   # the same cell for real on the same mesh
            real = ST.build_cell(cfg, shape, mesh, seed=0)
            params = [p.detach().to_local() for p in real.args[0].parameters()]
            c = DR.count_step(real, mesh)
            rec["real"] = {
                "same_placements": real.in_shardings == spec.in_shardings,
                "finite_params": all(bool(torch.isfinite(p).all())
                                     for p in params),
                "flops": c.summary.flops,
                "kernel_nodes": c.kernel_nodes("flash_attention")
                + c.kernel_nodes("ssd_scan")
                + c.kernel_nodes("ssd_scan_backward")}
        cells[f"{arch} {kind}"] = rec
out["cells"] = cells
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_run():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_counter_ring_allreduce_bytes_over_a_fake_group(mesh_run):
    n = 8
    assert mesh_run["allreduce"]["groups"] == [n]
    assert mesh_run["allreduce"]["bytes"] == int(2 * (8 * 8 * 4) * (n - 1) / n)


@pytest.mark.parametrize("case,flops,local", [
    ("sharded", 2 * 64 * 2048 * 512, [64, 512]),
    ("replicated", 2 * 1024 * 2048 * 8192, [1024, 8192])])
def test_counter_counts_a_sharded_matmul_per_device(mesh_run, case, flops,
                                                    local):
    """(1024, 2048) @ (2048, 8192) on a (16, 16) mesh: sharded over rows
    (data) and columns (model), one device multiplies (64, 2048) by (2048,
    512); replicated, each device does the whole product."""
    got = mesh_run["sharded_mm"][case]
    assert got == {"flops": flops, "coll": 0, "local": local}


@pytest.mark.parametrize("cell", ["llama3.2-1b train", "llama3.2-1b prefill",
                                  "llama3.2-1b decode",
                                  "mamba2-130m prefill",
                                  "mamba2-130m decode", "mamba2-130m train"])
def test_smoke_cell_traces_on_a_fake_4x2_mesh(mesh_run, cell):
    rec = mesh_run["cells"][cell]
    assert rec["flops"] > 0 and rec["hbm"] > 0 and rec["args"] > 0
    assert rec["temp"] > 0
    if cell.endswith("train"):
        # sharded training communicates (grad reductions at minimum)
        assert rec["coll"] > 0


@pytest.mark.parametrize("cell,flash,ssd_nodes", [
    ("llama3.2-1b train", 2, 0), ("llama3.2-1b prefill", 1, 0),
    ("llama3.2-1b decode", 0, 0), ("mamba2-130m prefill", 0, 1),
    ("mamba2-130m train", 0, 2)])
def test_kernel_nodes_per_layer(mesh_run, cell, flash, ssd_nodes):
    """One flash / SSD node per block in a forward; the train step runs
    each block's forward twice (remat recomputes it in the backward);
    decode runs neither kernel."""
    rec = mesh_run["cells"][cell]
    assert rec["flash"] == flash * rec["layers"]
    assert rec["ssd"] == ssd_nodes * rec["layers"]


@pytest.mark.parametrize("cell,nodes", [
    ("mamba2-130m train", 1), ("mamba2-130m prefill", 0),
    ("mamba2-130m decode", 0), ("llama3.2-1b train", 0)])
def test_ssd_backward_nodes_per_layer(mesh_run, cell, nodes):
    """A train step's bf16 SSD backward on the mesh is one
    ``repro_torch::ssd_scan_backward`` node per SSD layer (the backward
    kernel, as the card runs it; no recompute of ``ssd_chunked``); serving
    and models without SSD layers run none."""
    rec = mesh_run["cells"][cell]
    assert rec["ssd_backward"] == nodes * rec["layers"]


@pytest.mark.parametrize("cell,forward,backward", [
    ("mamba2-130m train", 2, 1), ("mamba2-130m prefill", 1, 0),
    ("mamba2-130m decode", 1, 0), ("llama3.2-1b train", 2, 1),
    ("llama3.2-1b prefill", 1, 0)])
def test_norm_nodes_per_layer(mesh_run, cell, forward, backward):
    """The bf16 norms whose normed dim is whole on the (4, 2) mesh are one
    ``repro_torch::rms_norm`` node each (the kernel, as the card runs it),
    on each rank's rows: a block's input norm (twice in a train step, remat
    recomputing it) and the final norm, with one backward node each. The
    mixer's gated norm at d_inner and llama's second norm (``add_norm``'s
    float32 sum) keep the eager chain: the first's width is split over the
    model axis, whose mean DTensor reduces across ranks."""
    rec = mesh_run["cells"][cell]
    train = cell.endswith("train")
    assert rec["norm"] == [forward * rec["layers"] + 1,
                           backward * rec["layers"] + int(train)]


@pytest.mark.parametrize("cell,nodes", [
    ("llama3.2-1b train", [1, 1]), ("llama3.2-1b prefill", [0, 0]),
    ("llama3.2-1b decode", [0, 0])])
def test_optimizer_kernel_nodes(mesh_run, cell, nodes):
    """A train step's optimizer on the mesh is the AdamW kernel's norm and
    update, one node each over every local shard; serving runs neither."""
    assert mesh_run["cells"][cell]["adamw"] == nodes


@pytest.mark.parametrize("cell", ["llama3.2-1b train", "llama3.2-1b prefill",
                                  "mamba2-130m prefill", "mamba2-130m train"])
def test_seeded_cell_is_the_traced_cell_on_real_tensors(mesh_run, cell):
    """``build_cell(..., seed=0)`` gives the traced cell's placements on
    real tensors (the random init), and its step runs on that mesh (the
    collectives of a fake group move nothing). On CPU tensors the model
    takes the reference route, not the kernels' ops: the real count is
    held against the trace on the card (``chip_smoke.py`` phase 16)."""
    real = mesh_run["cells"][cell]["real"]
    assert real["same_placements"] and real["finite_params"]
    assert real["flops"] > 0 and real["kernel_nodes"] == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_dryrun_cli_writes_the_reference_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "prefill_32k", "--device", "cpu",
         "--out", str(tmp_path)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[mamba2_130m_prefill_32k_single] ok" in out.stdout
    rec = json.loads((tmp_path / "mamba2_130m_prefill_32k_single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec) >= {"build_s", "trace_s", "memory_analysis",
                        "hlo_summary", "roofline"}
    rl = rec["roofline"]
    assert rl["hlo_flops_per_dev"] > 0 and rl["hlo_bytes_per_dev"] > 0
    assert math.isclose(rl["t_compute_s"],
                        rl["hlo_flops_per_dev"] / RL.PEAK_FLOPS)
    cfg = CB.get_config("mamba2-130m")
    assert rec["hlo_summary"]["by_opcode"]["repro_torch.ssd_scan"][
        "count"] == cfg.num_layers
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def test_dryrun_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "prefill_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr

"""Training on a mesh (``Trainer(mesh=...)``, ``repro_torch.launch.mesh``,
``repro_torch.distributed.sharding``): llama3.2-1b SMOKE in float32 on a
(2, 2) ``("data", "model")`` mesh of 4 ``gloo`` ranks — its 4 query heads
over two ``model`` ranks, 2 kv heads replicated, so rank 1 of the model
axis must attend with kv head 1 — for 3 steps from the reference's initial
parameters, against the reference's ``Trainer`` on the Auto-axis (2, 2)
mesh of 4 forced host devices and against the port's ``mesh=None``
trainer; the elastic re-mesh (saved on (2, 2), restored on (2, 1) and on
one device bit for bit, then one more step); and the launcher's
``--devices 4 --model-parallel 2`` on the CPU.

The reference runs on a mesh built as ``jax.sharding.Mesh(devices, axes)``
(Auto axes): ``repro.launch.mesh.make_mesh`` calls ``jax.make_mesh``,
which in jax 0.9.0 builds Explicit axes, and the reference's trainer then
stops at its embedding gather.

Bars, the train step's (``tests/test_torch_train_step.py``): loss, grad_norm and lr
within rtol 1e-5 at every step; every parameter within atol 5e-5 + rtol
1e-5 after the last.
"""
import subprocess
import sys

import numpy as np
from torch.distributed.tensor import Replicate, Shard

import _mesh_ranks as R
from _torch_state import one_torch_thread  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
ARCH, SEQ = "llama3_2_1b", 32


def _hold(hist, ref_hist, state=None, ref_params=None):
    for h, r in zip(hist, ref_hist, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            assert R.close(h[k], r[k], 1e-5), (h["step"], k, h[k], r[k])
    if state is not None:
        for k, want in ref_params.items():
            np.testing.assert_allclose(state["params"][k], want, atol=5e-5,
                                       rtol=1e-5, err_msg=k)


def test_llama_on_a_2x2_mesh_matches_the_reference_and_one_device(tmp_path):
    ref = R.reference_train(REPO, tmp_path, ARCH, SEQ)
    assert ref["devices"] == 4
    init = R.port_names(ARCH, "float32", ref["init"])
    job = dict(arch=ARCH, dtype="float32", mesh=((2, 2), ("data", "model")),
               seq=SEQ, batch=4, steps=3, hp=R.HP, params=init,
               ckpt_dir=str(tmp_path / "ckpt"))
    mesh = R.ranks(REPO, tmp_path, "train", 4, job, "mesh22")
    assert mesh["world"] == 4
    # the layout the rules give: q heads and the MLP over model, the
    # d_model dims over data, kv heads replicated, kv head_dim over model
    pl = mesh["rank_placements"]
    assert pl["blocks.0.attn.wq"] == (Shard(0), Shard(1))
    assert pl["blocks.0.attn.wk"] == (Shard(0), Shard(2))
    assert pl["blocks.0.ffn.wd"] == (Shard(1), Shard(0))
    assert pl["embed.tok"] == (Replicate(), Shard(0))
    final = R.port_names(ARCH, "float32", ref["final"])
    _hold(mesh["history"], ref["history"], mesh["state"], final)
    one = R.one_device(ARCH, "float32", init, SEQ, 3)
    _hold(mesh["history"], one["history"], mesh["state"],
          one["state"]["params"])

    # elastic re-mesh: the (2, 2) run's step-3 checkpoint on half the ranks
    job2 = dict(job, mesh=((2, 1), ("data", "model")), steps=1,
                restore_dir=job["ckpt_dir"], ckpt_dir=None, params=None)
    half = R.ranks(REPO, tmp_path, "train", 2, job2, "mesh21")
    assert half["world"] == 2 and half["restored"]
    assert half["resume_step"] == 3
    none = R.one_device(ARCH, "float32", init, SEQ, 1,
                        ckpt_dir=job["ckpt_dir"], restore=True)
    assert none["restored"]
    for got in (half["after_restore"], none["after_restore"]):
        for part in ("params", "m"):
            for k, v in mesh["state"][part].items():
                np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    # training continues on the smaller mesh as on one device
    assert half["history"][0]["step"] == 4
    assert np.isfinite(half["history"][0]["loss"])
    _hold(half["history"], none["history"], half["state"],
          none["state"]["params"])


def test_launcher_trains_on_four_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "32", "--devices", "4",
         "--model-parallel", "2", "--log-every", "1"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert "on 4 ranks, mesh (2, 2) ('data', 'model'), cpu" in lines[0]
    # rank 0 alone prints: two step lines and the last
    assert sum(line.startswith("step") for line in lines) == 2
    assert lines[-1].startswith("done: step 2 loss ")
    assert np.isfinite(float(lines[-1].split()[-1]))

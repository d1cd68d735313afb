"""Training on a (2, 2) ``("data", "model")`` mesh of 4 ``gloo`` ranks,
the ssm and moe families (see ``tests/test_torch_mesh_train.py`` for the
dense family, the re-mesh and the launcher):

- mamba2-130m SMOKE in float32, 3 steps from the reference's initial
  parameters, against the reference's ``Trainer`` on the Auto-axis (2, 2)
  mesh and against the port's ``mesh=None`` trainer, at the train-step bars
  (loss, grad_norm and lr within rtol 1e-5; parameters within atol 5e-5 +
  rtol 1e-5). Its inner width and SSD heads shard over ``model``.
- dbrx-132b SMOKE (the MoE dispatch and combine under the mesh). The
  reference cannot run this case under jax 0.9.0: on the Auto mesh in
  float32 its ``dispatch_bwd`` / ``combine_bwd`` return bfloat16
  cotangents for float32 operands and the backward stops at a ``lax.mul``
  of bfloat16 by float32. So it is held against the port's ``mesh=None``
  trainer. The mesh's backward rounds those cotangents to bfloat16, the
  reference's design, so only the forward keeps the train-step bar: the first
  loss within rtol 1e-5. The gradient norms are held at rtol 1e-3 and the
  later losses at rtol 1e-3 (measured on the CPU, steps 1-3: grad_norm
  2.4e-5, 6.6e-5, 2.8e-4; loss 8.2e-8, 3.2e-5, 2.1e-5; ``pytest -s``
  prints them). The pair of
  ``autograd.Function``s itself is held exactly: on the mesh each one's
  forward equals the one-device scatter-add or gather, and its gradient
  equals the other applied on one device to the cotangent rounded to
  bfloat16, bit for bit.
"""
import numpy as np
from torch.distributed.tensor import Shard

import _mesh_ranks as R
from _torch_state import one_torch_thread  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _hold(hist, ref_hist, rtol=1e-5):
    for h, r in zip(hist, ref_hist, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            assert R.close(h[k], r[k], rtol), (h["step"], k, h[k], r[k])


def _params(state, want):
    for k, v in want.items():
        np.testing.assert_allclose(state["params"][k], v, atol=5e-5,
                                   rtol=1e-5, err_msg=k)


def test_mamba_on_a_2x2_mesh_matches_the_reference_and_one_device(tmp_path):
    arch, seq = "mamba2_130m", 64
    ref = R.reference_train(REPO, tmp_path, arch, seq)
    init = R.port_names(arch, "float32", ref["init"])
    job = dict(arch=arch, dtype="float32", mesh=((2, 2), ("data", "model")),
               seq=seq, batch=4, steps=3, hp=R.HP, params=init)
    mesh = R.ranks(REPO, tmp_path, "train", 4, job, "mamba22")
    assert mesh["rank_placements"]["blocks.0.w_x"] == (Shard(0), Shard(1))
    _hold(mesh["history"], ref["history"])
    _params(mesh["state"], R.port_names(arch, "float32", ref["final"]))
    one = R.one_device(arch, "float32", init, seq, 3)
    _hold(mesh["history"], one["history"])
    _params(mesh["state"], one["state"]["params"])


def test_dbrx_on_a_2x2_mesh_against_one_device(tmp_path):
    arch, seq = "dbrx_132b", 32
    from repro_torch.models import model as M
    model = M.init(R._cfg(arch, "float32"), seed=0, device="cpu")
    init = {k: p.detach().numpy() for k, p in model.named_parameters()}
    job = dict(arch=arch, dtype="float32", mesh=((2, 2), ("data", "model")),
               seq=seq, batch=4, steps=3, hp=R.HP, params=init)
    mesh = R.ranks(REPO, tmp_path, "train", 4, job, "dbrx22")
    one = R.one_device(arch, "float32", init, seq, 3)
    gaps = [{k: abs(h[k] - o[k]) / abs(o[k]) for k in ("loss", "grad_norm")}
            for h, o in zip(mesh["history"], one["history"])]
    print("dbrx mesh vs one device, relative:", gaps)
    assert R.close(mesh["history"][0]["loss"], one["history"][0]["loss"],
                   1e-5)
    _hold(mesh["history"], one["history"], rtol=1e-3)
    assert all(np.isfinite(v).all() for v in mesh["state"]["params"].values())


def test_moe_dispatch_and_combine_functions_on_the_mesh(tmp_path):
    rng = np.random.default_rng(0)
    G, Sk, E, C, D = 4, 12, 4, 5, 8
    flat_e = rng.integers(0, E, (G, Sk))
    pos = np.stack([[int((flat_e[g, :i] == flat_e[g, i]).sum())
                     for i in range(Sk)] for g in range(G)])
    keep = pos < C
    job = dict(src=(rng.standard_normal((G, Sk, D)) * keep[..., None])
               .astype(np.float32),
               eo=rng.standard_normal((G, E, C, D)).astype(np.float32),
               ct_d=rng.standard_normal((G, E, C, D)).astype(np.float32),
               ct_c=rng.standard_normal((G, Sk, D)).astype(np.float32),
               flat_e=flat_e, pos=np.minimum(pos, C - 1))
    errs = R.ranks(REPO, tmp_path, "moe_functions", 4, job, "moefn")
    for k in ("dispatch", "dispatch_grad", "combine", "combine_grad"):
        assert errs[k] == 0.0, errs
    assert errs["dispatch_grad_vs_f32"] > 0   # the bfloat16 cast is there

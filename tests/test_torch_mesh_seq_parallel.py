"""Sequence parallelism on a mesh (``ModelConfig.seq_parallel``): the
blocks keep the residual stream sharded along the sequence over ``model``
and gather it whole for attention and the MLP
(``repro_torch/models/transformer.py``, the reference's
``src/repro/models/transformer.py``). llama3.2-1b SMOKE in float32 with
``seq_parallel=True`` on a (2, 2) ``("data", "model")`` mesh of 4 ``gloo``
ranks for 3 steps from the reference's initial parameters, against the
reference's ``Trainer`` with the same flag on the Auto-axis (2, 2) mesh of 4
forced host devices and against the port's ``mesh=None`` trainer.

Bars, those of ``tests/test_torch_mesh_train.py``: loss, grad_norm and lr
within rtol 1e-5 at every step; every parameter within atol 5e-5 + rtol
1e-5 after the last.
"""
from torch.distributed.tensor import Shard

import _mesh_ranks as R
from _torch_state import one_torch_thread  # noqa: F401
from test_torch_mesh_train import ARCH, REPO, SEQ, _hold


def test_seq_parallel_on_a_2x2_mesh_matches_the_reference_and_one_device(
        tmp_path):
    ref = R.reference_train(REPO, tmp_path, ARCH, SEQ, seq_parallel=True)
    assert ref["devices"] == 4
    init = R.port_names(ARCH, "float32", ref["init"])
    job = dict(arch=ARCH, dtype="float32", mesh=((2, 2), ("data", "model")),
               seq=SEQ, batch=4, steps=3, hp=R.HP, params=init,
               seq_parallel=True)
    mesh = R.ranks(REPO, tmp_path, "train", 4, job, "sp22")
    assert mesh["world"] == 4
    # the residual stream ran sharded: batch over data, sequence over model
    assert mesh["seq_shard_layouts"] == {(Shard(0), Shard(1))}
    final = R.port_names(ARCH, "float32", ref["final"])
    _hold(mesh["history"], ref["history"], mesh["state"], final)
    one = R.one_device(ARCH, "float32", init, SEQ, 3, seq_parallel=True)
    _hold(mesh["history"], one["history"], mesh["state"],
          one["state"]["params"])

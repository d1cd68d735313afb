"""The remaining families on a (2, 2) ``("data", "model")`` mesh of 4
``gloo`` ranks, one float32 SMOKE train step each from the port's own
initial parameters, against the port's ``mesh=None`` trainer at the
train-step bars (loss, grad_norm and lr within rtol 1e-5; every parameter
within atol 5e-5 + rtol 1e-5): recurrentgemma-2b (the RG-LRU blocks'
three ``constrain`` sites, rglru width over ``model``, two local-attention
windows), whisper-tiny (the bidirectional encoder, and cross attention
to its output) and llama-3.2-vision-90b (the gated cross blocks, gates
set to 0.5 / -0.3 so they add to the stream). The reference's trainer is not run here: these
families' mesh runs add no rule that ``tests/test_torch_mesh_train.py``
and ``tests/test_torch_mesh_families.py`` do not already hold against
it, and each would cost a JAX compile of its own."""
import numpy as np

import _mesh_ranks as R
from _torch_state import VLM_GATES, one_torch_thread  # noqa: F401

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
CASES = (("recurrentgemma_2b", 64), ("whisper_tiny", 32),
         ("llama3_2_vision_90b", 32))


def _init(arch):
    from repro_torch.models import model as M
    model = M.init(R._cfg(arch, "float32"), seed=0, device="cpu")
    out = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    for k in out:
        if k.endswith(".gate_attn"):
            out[k][...] = VLM_GATES[0]
        elif k.endswith(".gate_mlp"):
            out[k][...] = VLM_GATES[1]
    return out


def test_other_families_on_a_2x2_mesh_match_one_device(tmp_path):
    inits = {arch: _init(arch) for arch, _ in CASES}
    jobs = [dict(arch=arch, dtype="float32",
                 mesh=((2, 2), ("data", "model")), seq=seq, batch=4,
                 steps=1, hp=R.HP, params=inits[arch])
            for arch, seq in CASES]
    outs = R.ranks(REPO, tmp_path, "train_each", 4, {"jobs": jobs}, "other")
    for (arch, seq), mesh in zip(CASES, outs, strict=True):
        one = R.one_device(arch, "float32", inits[arch], seq, 1)
        for k in ("loss", "grad_norm", "lr"):
            got, want = mesh["history"][0][k], one["history"][0][k]
            assert R.close(got, want, 1e-5), (arch, k, got, want)
        for k, v in one["state"]["params"].items():
            np.testing.assert_allclose(mesh["state"]["params"][k], v,
                                       atol=5e-5, rtol=1e-5,
                                       err_msg=f"{arch} {k}")
        sharded = [k for k, pl in mesh["rank_placements"].items()
                   if any(p.is_shard() for p in pl)]
        assert sharded, arch

"""The port's logical-axis rules (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) against the reference's
(``repro.distributed.sharding``, ``repro.launch.mesh``): the twins of
``tests/test_sharding.py``'s rule tests, and for every config of
``configs/`` at full size every parameter's spec against the reference's
``fit_spec(param_spec(...))`` on abstract 16x16 and 2x16x16 meshes. A port
spec is a tuple; the reference's ``PartitionSpec`` compares as one. Also
the vocab-sharded embedding and loss on a (2, 2) ``gloo`` mesh against
the port's one-device functions (which ``tests/test_torch_lm.py`` holds
against the reference)."""
import pathlib

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as JCB
from repro.distributed import sharding as JSH
from repro.launch import mesh as JLM
from repro.models import model as JM
from repro_torch.configs import base as CB
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import data_axis_size, make_abstract_mesh
from repro_torch.models import model as M

REPO = pathlib.Path(__file__).resolve().parent.parent
# the port's configurations that the reference has (it has no
# granite_4_0_h_small to compare with)
ARCHS = sorted(p.stem for p in pathlib.Path(CB.__file__).parent.glob("*.py")
               if p.stem not in ("__init__", "base")
               and p.stem in JCB.ARCH_IDS)


@pytest.fixture(scope="module")
def mesh():
    return make_abstract_mesh((1, 1), ("data", "model"))


def test_param_rules(mesh):
    assert SH.param_spec(("embed", "mlp"), mesh) == P("data", "model")
    assert SH.param_spec(("vocab", "embed"), mesh) == P("model", "data")
    assert SH.param_spec(("layers", "embed", "heads", "head_dim"), mesh) == \
        P(None, "data", "model")


def test_act_rules_pod_axis_collapses(mesh):
    # mesh has no 'pod' axis -> batch maps to just 'data'
    assert SH.act_spec(("batch", "seq"), mesh) == P("data")


def test_fit_spec_drops_nondivisible():
    m = make_abstract_mesh((1, 2), ("data", "model"))
    spec = ("model", None)
    assert SH.fit_spec(spec, (6, 3), m) == P("model")   # 6 % 2 == 0 kept
    assert SH.fit_spec(spec, (5, 3), m) == P()          # 5 % 2 != 0 dropped


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert SH.constrain(x, "batch", None) is x


def test_validate_axes_catches_rank_mismatch():
    params = {"w": torch.zeros((2, 3))}
    with pytest.raises(ValueError):
        SH.validate_axes(params, {"w": ("embed",)})
    SH.validate_axes(params, {"w": ("embed", "mlp")})  # ok
    with pytest.raises(ValueError):
        SH.validate_axes(params, {"v": ("embed", "mlp")})


def test_data_axis_size():
    assert data_axis_size(make_abstract_mesh((2, 2), ("data", "model"))) == 2
    assert data_axis_size(
        make_abstract_mesh((2, 2, 1), ("pod", "data", "model"))) == 4


@pytest.mark.parametrize("shape,axes", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((2, 4), ("data", "model"))])
def test_rules_match_the_reference_on_every_logical_axis(shape, axes):
    """Every logical name of both tables, alone and in pairs, under both
    rule tables, and fit_spec on dims that divide and that do not."""
    jm, tm = JLM.make_abstract_mesh(shape, axes), make_abstract_mesh(shape,
                                                                     axes)
    names = sorted({*JSH.PARAM_RULES, *JSH.ACT_RULES} - {None}) + [None]
    assert SH.PARAM_RULES == JSH.PARAM_RULES
    assert SH.ACT_RULES == JSH.ACT_RULES
    for a in names:
        for b in names:
            for port, ref in ((SH.param_spec, JSH.param_spec),
                              (SH.act_spec, JSH.act_spec)):
                spec = port((a, b), tm)
                assert spec == tuple(ref((a, b), jm)), (a, b)
                for dims in ((32, 48), (6, 16), (3, 5)):
                    assert SH.fit_spec(spec, dims, tm) == tuple(
                        JSH.fit_spec(ref((a, b), jm), dims, jm)), (a, b, dims)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = make_abstract_mesh((2, 4, 8), ("pod", "data", "model"))
    assert SH.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.placements((), m) == (Replicate(),) * 3
    one = make_abstract_mesh((1, 1), ("data", "model"))   # splits nothing
    assert SH.placements(("data", "model"), one) == (Replicate(),) * 2


def _reference_specs(arch, jm):
    """Port name -> the reference's fit_spec(param_spec(axes)) of the
    parameter's stacked array, its leading layer entry dropped."""
    import jax
    cfg = JCB.get_config(arch)
    sds, axes = JM.abstract_init(cfg)
    flat_a, tdef = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=JSH.is_axes_leaf)
    flat_s = tdef.flatten_up_to(sds)
    out = {}
    for (path, ax), s in zip(flat_a, flat_s):
        key = ".".join(k.key for k in path)
        spec = tuple(JSH.fit_spec(JSH.param_spec(ax, jm), s.shape, jm))
        if M.stacked(key):
            top, rest = key.split(".", 1)
            for i in range(s.shape[0]):
                out[f"{top}.{i}.{rest}"] = spec[1:]
        else:
            out[key] = spec
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_spec_matches_the_reference(arch):
    """At full size on ``device="meta"``: the port's per-layer tensors take
    the reference's specs (its stacked ``layers`` entry dropped), on the
    16x16 and 2x16x16 production meshes."""
    cfg = CB.get_config(arch)
    model = M.build(cfg, device="meta")
    params = dict(model.named_parameters())
    axes = M.param_axes(model)
    SH.validate_axes(params, axes)
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        jm = JLM.make_abstract_mesh(shape, names)
        tm = make_abstract_mesh(shape, names)
        ref = _reference_specs(arch, jm)
        assert set(ref) == set(params)
        port = {k: SH.fit_spec(SH.param_spec(axes[k], tm),
                               tuple(params[k].shape), tm) for k in params}
        bad = {k: (port[k], ref[k]) for k in params if port[k] != ref[k]}
        assert not bad, list(bad.items())[:5]
        pl = SH.tree_param_shardings(axes, tm, params)
        assert all(len(v) == len(shape) for v in pl.values())


def test_stacked_axis_is_the_only_one_dropped():
    """Each port tensor's axes are the reference's minus ``"layers"``."""
    import jax
    for arch in ("llama3_2_1b", "mamba2_130m", "dbrx_132b",
                 "recurrentgemma_2b", "whisper_tiny",
                 "llama3_2_vision_90b"):
        cfg = JCB.get_config(arch, smoke=True)
        _, axes = JM.abstract_init(cfg)
        flat = jax.tree_util.tree_flatten_with_path(
            axes, is_leaf=JSH.is_axes_leaf)[0]
        ref = {".".join(k.key for k in p): a for p, a in flat}
        port = M.param_axes(M.build(CB.get_config(arch, smoke=True),
                                    device="meta"))
        for name, ax in port.items():
            key = name if not M.stacked(name) else \
                name.split(".")[0] + "." + name.split(".", 2)[2]
            want = ref[key][1:] if M.stacked(name) else ref[key]
            assert ref[key][:1] == ("layers",) or not M.stacked(name)
            assert ax == want, (arch, name, ax, want)


def test_meshes_need_their_ranks_and_never_fall_back():
    """A mesh needs a process group of prod(shape) ranks; asking for cuda
    without a card (or with fewer cards than ranks) raises, and nothing
    falls back to gloo or the CPU."""
    from repro_torch.launch import mesh as LM
    with pytest.raises(RuntimeError):
        LM.make_mesh((1, 1), ("data", "model"), device="cuda")
    with pytest.raises(RuntimeError):
        LM.spawn(print, 2, device="cuda")
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        make_abstract_mesh((2, 2), ("data",))
    m = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model")


def test_vocab_sharded_embedding_and_loss_stay_sharded(tmp_path):
    """On a (2, 2) gloo mesh with the vocab over ``model``: the lookup
    (masked local rows, one all-reduce) and the loss (local max, sum of
    exponentials and gold logit, one all-reduce each) equal the
    one-device functions, value and gradient, and neither gathers the
    table or the logits (no all-gather is issued). The vocab is padded
    (120 of 128), so the masked tail falls on the second ``model`` rank."""
    import _mesh_ranks as R
    rng = np.random.default_rng(0)
    B, S, D, V, PV = 4, 6, 8, 120, 128
    job = dict(table=rng.standard_normal((PV, D)).astype(np.float32),
               tokens=rng.integers(0, V, (B, S)).astype(np.int32),
               ct=rng.standard_normal((B, S, D)).astype(np.float32),
               logits=rng.standard_normal((B, S, PV)).astype(np.float32),
               labels=rng.integers(0, V, (B, S)).astype(np.int32),
               vocab=V)
    out = R.ranks(REPO, tmp_path, "vocab_parallel", 4, job, "vocab")
    assert out["x"] == 0.0, out                   # one row, zeros added
    assert out["x_placements"] == (Shard(0), Replicate())
    for k in ("table_grad", "loss", "logits_grad"):
        assert out[k] <= 1e-6, out
    for comms in (out["embed_comms"], out["loss_comms"]):
        assert comms and not any("gather" in c for c in comms), out

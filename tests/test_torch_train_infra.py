"""The port's training infrastructure (``repro_torch.train``, the loss)
against the reference's: the twins of every ``tests/test_train_infra.py``
test that needs no mesh and no ``distributed/`` module (optimizer,
checkpoint, trainer, fault tolerance; the data twins are in
``test_torch_data.py``), and the pieces held against ``repro`` on the same
numpy inputs: ``cross_entropy_loss``, ``lr_schedule`` and
``apply_updates`` (float32, rtol 1e-6), and the weight-decay rule on the
stacked parameter tree.

``test_elastic_restore_across_meshes`` and the compression tests wait for
the distributed port (``ROADMAP.md`` B6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.train import optimizer as JOPT
from repro_torch.configs import base as TCB
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.models import layers as L
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as OPT
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               run_with_recovery)
from repro_torch.train.trainer import Trainer, TrainConfig

from _torch_state import lm_pair, one_torch_thread  # noqa: F401

F32_EXACT = dict(rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# optimizer (twins)
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    hp = OPT.OptHParams(learning_rate=0.1, weight_decay=0.0, warmup_steps=0,
                        decay_steps=1000, grad_clip=1e9)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = OPT.init_state(params, hp)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = OPT.apply_updates(params, grads, state, hp)
    assert float(params["w"].abs().max()) < 1e-2


def test_lr_schedule_warmup_then_cosine():
    hp = OPT.OptHParams(learning_rate=1.0, warmup_steps=10, decay_steps=100,
                        min_lr_ratio=0.1)
    lr = lambda s: float(OPT.lr_schedule(hp, torch.tensor(s)))  # noqa: E731
    assert lr(5) == pytest.approx(0.5)
    assert lr(10) == pytest.approx(1.0, abs=0.01)
    assert lr(100) == pytest.approx(0.1, abs=0.01)
    assert lr(55) < lr(20)


def test_bf16_optimizer_state():
    hp = OPT.OptHParams(state_dtype="bfloat16")
    params = {"w": torch.zeros((4, 4))}
    state = OPT.init_state(params, hp)
    assert state["m"]["w"].dtype == torch.bfloat16
    grads = {"w": torch.ones((4, 4))}
    _, state, _ = OPT.apply_updates(params, grads, state, hp)
    assert state["m"]["w"].dtype == torch.bfloat16


def test_grad_clipping_bounds_update():
    hp = OPT.OptHParams(learning_rate=1.0, grad_clip=1.0, warmup_steps=0,
                        weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = OPT.init_state(params, hp)
    _, _, metrics = OPT.apply_updates(params, {"w": torch.full((3,), 1e6)},
                                      state, hp)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


# ---------------------------------------------------------------------------
# the same numpy inputs through both packages
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    hp = dict(learning_rate=3e-4, warmup_steps=7, decay_steps=50,
              min_lr_ratio=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(JOPT.lr_schedule(JOPT.OptHParams(**hp),
                                       jnp.asarray(steps)))
    got = OPT.lr_schedule(OPT.OptHParams(**hp), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_EXACT)


@pytest.mark.parametrize("vocab,pv", [(200, 256), (256, 256)])
def test_cross_entropy_matches_reference(vocab, pv):
    """Padded tail masked (vocab < pv) and not (vocab == pv)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, pv)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, size=(3, 7)).astype(np.int32)
    want = float(JL.cross_entropy_loss(jnp.asarray(logits),
                                       jnp.asarray(labels), vocab))
    got = L.cross_entropy_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), vocab)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **F32_EXACT)
    # bf16 logits are upcast first, as the reference does
    got16 = L.cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                                 torch.from_numpy(labels), vocab)
    want16 = float(JL.cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        vocab))
    np.testing.assert_allclose(float(got16), want16, **F32_EXACT)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    """Three AdamW steps on a stacked tree (blocks: a matrix and a vector
    per layer) and top-level matrix and vector, from the reference's
    state carried across by ``convert``: clipping active on step 1,
    float32 (rtol 1e-6) for params, moments and metrics; in bf16 the
    moments are compared after both round them."""
    rng = np.random.default_rng(1)
    tree = {"blocks": {"w": rng.standard_normal((2, 4, 3)),
                       "ln": rng.standard_normal((2, 3))},
            "emb": rng.standard_normal((5, 3)),
            "final_norm": rng.standard_normal((3,))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a, s=s: (rng.standard_normal(a.shape)
                                          * s).astype(np.float32), tree)
             for s in (3.0, 0.1, 0.2)]
    kw = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=5,
              state_dtype=state_dtype)
    jhp, hp = JOPT.OptHParams(**kw), OPT.OptHParams(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = JOPT.init_state(jp, jhp)
    params = {k: v.clone() for k, v in
              opt_state_from_numpy({"m": tree, "v": tree, "step": 0},
                                   device="cpu")["m"].items()}
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    assert state["m"]["blocks.1.w"].dtype == getattr(torch, state_dtype)
    for g in grads:
        jp, jstate, jm = JOPT.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), jstate, jhp)
        tg = opt_state_from_numpy({"m": g, "v": g, "step": 0},
                                  device="cpu")["m"]
        params, state, m = OPT.apply_updates(params, tg, state, hp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **F32_EXACT)
    got = opt_state_to_numpy({"m": params, "v": state["v"],
                              "step": state["step"]})
    assert int(got["step"]) == int(jstate["step"]) == 3
    for a, b in zip(jax.tree.leaves(got["m"]), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), **F32_EXACT)
    for a, b in zip(jax.tree.leaves(got["v"]),
                    jax.tree.leaves(jstate["v"])):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   **F32_EXACT)
    for a, b in zip(jax.tree.leaves(opt_state_to_numpy(state)["m"]),
                    jax.tree.leaves(jstate["m"])):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   **F32_EXACT)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"])
def test_weight_decay_follows_the_stacked_rule(arch):
    """Every parameter under ``blocks`` decays (per-layer norms, ``A_log``,
    ``D``, ``b_dt``, ``conv_b`` included: the reference's arrays there
    carry the layer axis) and top-level vectors (``final_norm``) do not;
    the rule is the reference's ``p.ndim >= 2`` on its own tree."""
    jcfg, params, tcfg, model = lm_pair(arch)
    ref_ndim = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        ref_ndim[".".join(k.key for k in path)] = leaf.ndim
    names = dict(model.named_parameters())
    for name, p in names.items():
        key = name if not name.startswith("blocks.") else \
            "blocks." + name.split(".", 2)[2]
        assert OPT.decays(name, p) == (ref_ndim[key] >= 2), name
    assert OPT.decays("blocks.0.ln1" if arch.startswith("llama")
                      else "blocks.0.A_log",
                      names["blocks.0.ln1" if arch.startswith("llama")
                            else "blocks.0.A_log"])
    assert not OPT.decays("final_norm", names["final_norm"])
    # and apply_updates applies it: zero gradients move only decayed ones
    hp = OPT.OptHParams(learning_rate=0.1, warmup_steps=0)
    params = {k: p.detach().clone() for k, p in names.items()}
    before = {k: p.clone() for k, p in params.items()}
    OPT.apply_updates(params, {k: torch.zeros_like(p)
                               for k, p in params.items()},
                      OPT.init_state(params, hp), hp)
    for k, p in params.items():
        moved = not torch.equal(p, before[k])
        assert moved == (OPT.decays(k, p) and bool(before[k].any())), k


# ---------------------------------------------------------------------------
# checkpoint (twins, and the port's device moves)
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return [v for _, v in CKPT._flatten(tree)]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    CKPT.save(tmp_path, 3, t)
    out = CKPT.restore(tmp_path, 3, t)
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        CKPT.save(tmp_path, s, t, keep=2)
    assert CKPT.all_steps(tmp_path) == [4, 5]
    assert CKPT.latest_step(tmp_path) == 5
    step, out = CKPT.restore_latest(tmp_path, t)
    assert step == 5


def test_checkpoint_no_partial_publish(tmp_path):
    """A leftover .tmp dir is never listed as a valid checkpoint."""
    t = _tree()
    CKPT.save(tmp_path, 1, t)
    (tmp_path / "step_2.tmp").mkdir()
    assert CKPT.all_steps(tmp_path) == [1]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    t = _tree()
    CKPT.save(tmp_path, 1, t)
    bad = dict(t, a=torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        CKPT.restore(tmp_path, 1, bad)


def test_checkpoint_files_are_the_reference_layout(tmp_path):
    """manifest.json + one ``leaf_*.npy`` per leaf; bf16 stored bit-cast
    to uint16 as the reference stores it; a missing leaf raises KeyError."""
    t = _tree()
    final = CKPT.save(tmp_path, 1, t)
    files = sorted(p.name for p in final.iterdir())
    assert files == ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
                     "manifest.json"]
    bits = np.load(final / "leaf_00001.npy")
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, np.full(4, 0x3F80, np.uint16))
    with pytest.raises(KeyError):
        CKPT.restore(tmp_path, 1, dict(t, extra=torch.zeros(1)))


# ---------------------------------------------------------------------------
# trainer and fault tolerance (twins)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_cfg():
    return TCB.get_config("llama3_2_1b", smoke=True)


def test_trainer_loss_decreases(smoke_cfg):
    tc = TrainConfig(seq_len=64, global_batch=8, num_steps=30, log_every=0)
    tr = Trainer(smoke_cfg, tc, device="cpu")
    tr.run()
    first = np.mean([h["loss"] for h in tr.history[:5]])
    last = np.mean([h["loss"] for h in tr.history[-5:]])
    assert last < first


def test_grad_accum_matches_single_batch(smoke_cfg):
    """microbatches=2 over one batch == microbatches=1 (same data, same
    update, modulo f32 reduction order)."""
    tc1 = TrainConfig(seq_len=32, global_batch=4, num_steps=1, log_every=0,
                      microbatches=1, seed=3)
    tc2 = TrainConfig(seq_len=32, global_batch=4, num_steps=1, log_every=0,
                      microbatches=2, seed=3)
    t1, t2 = Trainer(smoke_cfg, tc1, device="cpu"), \
        Trainer(smoke_cfg, tc2, device="cpu")
    batch = next(t1.data)
    m1 = t1.train_one(batch)
    m2 = t2.train_one(batch)
    assert m1["loss"] == pytest.approx(m2["loss"], rel=2e-2)
    for (k, a), b in zip(t1.params.items(), t2.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-3, rtol=5e-2, err_msg=k)


def test_trainer_checkpoint_resume(tmp_path, smoke_cfg):
    tc = TrainConfig(seq_len=32, global_batch=4, num_steps=10, log_every=0,
                     ckpt_every=5, ckpt_dir=str(tmp_path))
    tr = Trainer(smoke_cfg, tc, device="cpu")
    tr.run()
    tr2 = Trainer(smoke_cfg, tc, device="cpu")
    assert tr2.maybe_restore()
    assert tr2.step == 10
    for a, b in zip(tr.params.values(), tr2.params.values()):
        assert torch.equal(a, b)


def test_fault_tolerance_recovers(tmp_path, smoke_cfg):
    inj = FailureInjector([4, 9])

    def mk(attempt):
        tc = TrainConfig(seq_len=32, global_batch=4, num_steps=12,
                         log_every=0, ckpt_every=3, ckpt_dir=str(tmp_path))
        return Trainer(smoke_cfg, tc, device="cpu")

    rep = run_with_recovery(mk, 12, injector=inj)
    assert rep.restarts == 2
    assert rep.completed_steps == 12
    assert rep.preemptions == [4, 9]
    assert np.isfinite(rep.final_metrics["loss"])


def test_resume_continues_bit_exactly(tmp_path, smoke_cfg):
    """A run checkpointed at step 4 and resumed to step 8 ends with the
    same params, moments and losses, bit for bit, as one uninterrupted
    run: the data index and the optimizer state are restored with the
    params."""
    def tc(d, steps):
        return TrainConfig(seq_len=32, global_batch=4, num_steps=steps,
                           log_every=0, ckpt_every=4, ckpt_dir=d)
    full = Trainer(smoke_cfg, tc(None, 8), device="cpu")
    full.run()
    part = Trainer(smoke_cfg, tc(str(tmp_path), 4), device="cpu")
    part.run()
    resumed = Trainer(smoke_cfg, tc(str(tmp_path), 8), device="cpu")
    assert resumed.maybe_restore() and resumed.step == 4
    assert resumed.data.index == 4
    resumed.run()
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[4:]]
    for k, p in full.params.items():
        assert torch.equal(p, resumed.params[k]), k
        assert torch.equal(full.opt_state["m"][k], resumed.opt_state["m"][k])
        assert torch.equal(full.opt_state["v"][k], resumed.opt_state["v"][k])
    assert int(resumed.opt_state["step"]) == 8


def test_trainer_needs_cuda_unless_asked_for_cpu(smoke_cfg):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(smoke_cfg, TrainConfig(num_steps=1))

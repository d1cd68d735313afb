"""The port's train step (``repro_torch.launch.steps.make_train_step``)
against the reference's jitted one (``repro.launch.steps.make_train_step``)
from the same parameters and optimizer state (carried across by
``repro_torch.convert``) on the same batches of the data pipeline: the
dense family (llama3.2-1b: GQA, tied embeddings, remat on;
codeqwen1.5-7b: MHA, qkv bias, untied embeddings) and the ssm family
(mamba2-130m, two SSD chunks) at their SMOKE sizes, three steps, checked
after the first and the third; the moe (dbrx-132b, the aux losses'
gradients through the router), vlm, audio and hybrid families too. Weight
decay follows the reference's stacked-ndim rule (per-layer norms decay),
so the parameters can agree.
In float32 the same holds with gradient accumulation: 2 microbatches
against the reference trainer's ``_accumulate_train_step``.

Bars, from the gaps these tests measure on the CPU (``pytest -s`` prints
them; the largest of the configs in brackets):

- float32: loss, grad_norm and lr within rtol 1e-5 [2.5e-7, 2.3e-7,
  6.0e-8]; every parameter within atol 5e-5 + rtol 1e-5 [2.13e-5: an
  element of codeqwen's ``wo`` whose first gradient is at rounding level,
  so Adam's normalised step there follows the rounding; 3.14e-5 with 2
  microbatches; 5e-5 is 5% of one step at lr 1e-3]; the moments after 3
  steps within 1e-4 of each tensor's largest moment. The four later
  families: metrics [1.9e-6, dbrx's router-z through 2 microbatches],
  parameters [4.0e-5, dbrx with 2 microbatches; 9.9e-6 for the rest].
- bfloat16 (the activations; params and Adam state stay float32), every
  family: loss within rtol 1e-3 [3.25e-4, recurrentgemma-2b], grad_norm
  within rtol 5e-3 [4.03e-3, dbrx-132b at step 3]; the two packages round
  the activations at different points (XLA's reductions), and Adam turns
  each gradient element's sign into a step of up to lr, so parameters are
  held by the share of elements more than 1e-4 apart, at most 5% [2.52%,
  dbrx-132b], and the largest gap, at most 1e-2 [3.88e-3, about four
  steps' size]. dbrx-132b is the tightest: its bf16 router logits decide
  discrete expert choices, and at step 2 a few of its 256 choices a layer
  differ from the reference's, turning a rounding drift into a gradient
  gap. Its grad_norm gap was 5.3e-3 at step 2 while the port's CPU SiLU
  took autograd's gradient through its emulated ``1 / (1 + exp(-x))``;
  with the reference's derivative (``layers._ReferenceSilu``) the MoE
  layer's ``wi`` gradient is the reference's in all but 1 of 24,576
  elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JDP
from repro.launch import steps as JST
from repro.train import optimizer as JOPT
from repro.train import trainer as JTR
from repro_torch.convert import (lm_to_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy)
from repro_torch.launch import steps as ST
from repro_torch.train import optimizer as OPT

from _torch_state import VLM_GATES, lm_pair, one_torch_thread  # noqa: F401

HP = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
CASES = [("llama3_2_1b", 32), ("codeqwen1_5_7b", 32), ("mamba2_130m", 64)]
# the moe (aux-loss gradients through the router), vlm (cross blocks, gates
# set non-zero), audio and hybrid (two windows) families, held at the
# float32 and bfloat16 bars
LATER_CASES = [("dbrx_132b", 32), ("llama3_2_vision_90b", 32),
               ("whisper_tiny", 32), ("recurrentgemma_2b", 32)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run(arch, S, dtype, microbatches=1, overrides=None,
         state_dtype="float32"):
    """Yield (step, reference metrics, port metrics, reference params,
    port params, reference state, port state) after each of 3 steps. With
    ``microbatches`` > 1 the reference's step is its trainer's gradient
    accumulation (``trainer._accumulate_train_step``). ``overrides``
    replace config fields in both packages; ``state_dtype`` is both
    optimizers' moment dtype."""
    jcfg, params, tcfg, model = lm_pair(arch, dtype, gates=VLM_GATES,
                                        **(overrides or {}))
    model.requires_grad_(True)
    jhp = JOPT.OptHParams(**HP, state_dtype=state_dtype)
    hp = OPT.OptHParams(**HP, state_dtype=state_dtype)
    jstate = JOPT.init_state(params, jhp)
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    jstep = jax.jit(JST.make_train_step(jcfg, jhp) if microbatches == 1
                    else JTR._accumulate_train_step(jcfg, jhp, microbatches))
    step = ST.make_train_step(tcfg, hp, microbatches)
    pipe = JDP.make_pipeline(jcfg, seq_len=S, global_batch=4, seed=0)
    for i in range(3):
        b = pipe.batch_at(i)
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        _, state, m = step(model, state,
                           {k: torch.from_numpy(v) for k, v in b.items()})
        yield i + 1, jm, m, params, lm_to_numpy(model), jstate, state


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _check_float32(arch, S, microbatches, overrides=None):
    """Three float32 steps at the float32 bars; returns the last step's
    (reference state, port state)."""
    gaps = {"metrics": 0.0, "params": 0.0}
    for n, jm, m, jp, tp, jstate, state in _run(arch, S, "float32",
                                                microbatches, overrides):
        assert set(m) == set(jm)    # the moe family's aux losses too
        for k in jm:
            gaps["metrics"] = max(gaps["metrics"], _rel(m[k], jm[k]))
            assert _rel(m[k], jm[k]) <= 1e-5, (n, k, float(m[k]),
                                                float(jm[k]))
        if n in (1, 3):
            want, got = _leaves(jp), _leaves(tp)
            assert sorted(got) == sorted(want)
            for k in want:
                gaps["params"] = max(gaps["params"],
                                     float(np.abs(got[k] - want[k]).max()))
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=5e-5, err_msg=f"{n} {k}")
    print(f"{arch} float32, {microbatches} microbatch(es): largest "
          f"relative metric gap {gaps['metrics']:.3e}, largest parameter "
          f"gap {gaps['params']:.3e}")
    ts = opt_state_to_numpy(state)
    assert int(ts["step"]) == int(jstate["step"]) == 3
    for part in ("m", "v"):
        want, got = _leaves(jstate[part]), _leaves(ts[part])
        for k in want:
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, (part, k)
    return jstate, state


@pytest.mark.parametrize("arch,S", CASES + LATER_CASES)
def test_float32_train_step_matches_reference(arch, S):
    _check_float32(arch, S, 1)


@pytest.mark.parametrize("arch,S", CASES + LATER_CASES)
def test_float32_accumulated_train_step_matches_reference(arch, S):
    """Gradient accumulation: the batch of 4 as 2 microbatches of 2, the
    port's ``make_train_step(..., microbatches=2)`` against the reference
    trainer's jitted ``_accumulate_train_step(cfg, hp, 2)``: the gradients
    of the slices summed and divided, the loss and metrics averaged, under
    the same bars as one batch."""
    _check_float32(arch, S, 2)


@pytest.mark.parametrize("arch,S", CASES + LATER_CASES)
def test_bfloat16_train_step_stays_near_reference(arch, S):
    for n, jm, m, jp, tp, _, _ in _run(arch, S, "bfloat16"):
        rel_loss = _rel(m["loss"], jm["loss"])
        rel_norm = _rel(m["grad_norm"], jm["grad_norm"])
        assert rel_loss <= 1e-3, (n, float(m["loss"]), float(jm["loss"]))
        assert rel_norm <= 5e-3, n
        assert _rel(m["lr"], jm["lr"]) <= 1e-5
        want, got = _leaves(jp), _leaves(tp)
        gaps = np.concatenate([np.abs(got[k] - want[k]).ravel()
                               for k in want])
        print(f"{arch} bfloat16 step {n}: loss {rel_loss:.2e}, grad_norm "
              f"{rel_norm:.2e}, share of params > 1e-4 apart "
              f"{(gaps > 1e-4).mean():.2e}, largest gap {gaps.max():.2e}")
        assert (gaps > 1e-4).mean() <= 0.05, (n, (gaps > 1e-4).mean())
        assert gaps.max() <= 1e-2, (n, gaps.max())


def test_opt_state_round_trips_through_convert():
    """``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry the
    reference's state across and back: stacked moments per parameter name,
    bf16 moments exactly, the step."""
    jcfg, params, tcfg, model = lm_pair("mamba2_130m")
    jstate = JOPT.init_state(params, JOPT.OptHParams(state_dtype="bfloat16"))
    rng = np.random.default_rng(0)
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.bfloat16), jstate["m"]),
        "v": jax.tree.map(lambda a: jnp.asarray(
            rng.random(a.shape), jnp.bfloat16), jstate["v"]),
        "step": jnp.int32(5)}
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    names = dict(model.named_parameters())
    assert sorted(state["m"]) == sorted(names)
    for k, p in names.items():
        assert state["m"][k].shape == p.shape
        assert state["m"][k].dtype == torch.bfloat16
    back = opt_state_to_numpy(state)
    assert int(back["step"]) == 5
    for part in ("m", "v"):
        want, got = _leaves(jstate[part]), _leaves(back[part])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

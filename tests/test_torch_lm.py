"""The port's LM serving path (``repro_torch.models``, ``launch.steps``,
``convert``) against the reference's ``repro.models`` on the same
parameters and tokens: ``forward``, the prefill step and ``decode_step``
for the dense (llama3.2-1b) and ssm (mamba2-130m) families at their SMOKE
sizes, and the rest of the dense family (granite-3-2b, codeqwen1.5-7b,
qwen1.5-110b: qkv bias, untied embeddings, MHA) at theirs.

Parameters come from ``repro.models.model.init`` and are carried across
by ``lm_from_numpy``; tokens are made with numpy from a seed. Bars: in
float32, logits atol 1e-4 / rtol 1e-4 and the same next token; in
bfloat16, logits within 2e-2 x max |logits|. On the CPU the port's model
rounds where the reference's compiled model rounds (its attention regimes,
XLA's bfloat16 sigmoid, the float32 sum the fused add + norm sees), so in
bfloat16 most of these runs agree bit for bit; the bar leaves room for
the fusions that do not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCB
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import model as JM
from repro_torch.configs import base as TCB
from repro_torch.convert import lm_to_numpy
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import model as M

from _torch_state import lm_pair

F32 = dict(atol=1e-4, rtol=1e-4)


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)


def _logits_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch,S,overrides", [
    ("llama3_2_1b", 24, {}),                     # reference: _sdpa
    ("llama3_2_1b", 2048, {"num_layers": 1}),    # reference: blocked
    ("mamba2_130m", 64, {}),                     # 2 chunks of 32
    ("mamba2_130m", 20, {}),                     # one chunk of S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_step_match_reference(arch, S, overrides,
                                                  dtype):
    jcfg, params, tcfg, model = lm_pair(arch, dtype, **overrides)
    toks = _tokens(jcfg.vocab_size, 2 if S < 1024 else 1, S)
    want, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape            # the padded vocabulary
    _logits_close(got, want, dtype)
    if dtype == "float32":
        nxt = make_prefill_step(tcfg)(model, {"tokens":
                                              torch.from_numpy(toks)})
        jnxt = jax_prefill_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(arch, per_slot, dtype):
    """Teacher-forced decoding: every step's logits and next tokens, with a
    scalar ``cur_len`` or a per-slot (B,) one (slot 1 three positions
    ahead, as continuous batching leaves it).

    In float32 both sides get float32 caches (both ``decode_step``s take
    any cache dtype), so the step runs in float32 throughout. The default
    caches round each new K/V (and the conv window) to bfloat16: an f32
    difference of 1e-7 that straddles a bf16 rounding boundary moves that
    element by one bf16 ulp and the logits by about 1e-3, so those caches
    are held in the bfloat16 runs, at the bfloat16 bar."""
    jcfg, params, tcfg, model = lm_pair(arch, dtype, seed=2)
    B, T, max_len = 2, 6, 16
    toks = _tokens(jcfg.vocab_size, B, T, seed=3)
    jcache, _ = JM.init_cache(jcfg, B, max_len)
    cache = M.init_cache(tcfg, B, max_len, device="cpu")
    for k, v in jcache.items():   # the reference's cache layout and dtypes
        assert cache[k].dtype == getattr(torch, str(v.dtype))
        assert tuple(cache[k].shape) == v.shape
    if dtype == "float32":
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
        cache = {k: v.float() for k, v in cache.items()}
    jstep = jax.jit(lambda p, c, t, n: JM.decode_step(p, jcfg, c, t, n))
    step = make_decode_step(tcfg)
    offset = np.array([0, 3], np.int32)
    for t in range(T):
        cur = t + offset if per_slot else np.int32(t)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(cur))
        got, new_cache = M.decode_step(
            model, tcfg, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.as_tensor(cur))
        _logits_close(got, want, dtype)
        nxt, cache = step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                          torch.as_tensor(cur))
        assert all(torch.equal(cache[k], new_cache[k]) for k in cache)
        assert all(cache[k].dtype == getattr(torch, str(v.dtype))
                   for k, v in jcache.items())
        if dtype == "float32":
            np.testing.assert_array_equal(
                nxt.numpy(), np.asarray(jnp.argmax(want[:, -1:], -1)))


# the rest of the dense family at SMOKE sizes: granite (llama's layout, 3
# layers), codeqwen (MHA, qkv bias, untied embeddings), qwen1.5 (GQA, qkv
# bias, untied embeddings)
DENSE_FAMILY = ["granite_3_2b", "codeqwen1_5_7b", "qwen1_5_110b"]


@pytest.mark.parametrize("arch", DENSE_FAMILY)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_family_forward_and_prefill_step_match_reference(arch, dtype):
    jcfg, params, tcfg, model = lm_pair(arch, dtype)
    toks = _tokens(jcfg.vocab_size, 2, 24)
    want, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = M.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _logits_close(got, want, dtype)
    if dtype == "float32":
        nxt = make_prefill_step(tcfg)(model, {"tokens":
                                              torch.from_numpy(toks)})
        jnxt = jax_prefill_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("arch", DENSE_FAMILY)
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_family_decode_step_matches_reference(arch, per_slot, dtype):
    """Teacher-forced decoding as :func:`test_decode_step_matches_reference`
    runs it: float32 caches in float32, the default bfloat16 caches in
    bfloat16."""
    jcfg, params, tcfg, model = lm_pair(arch, dtype, seed=2)
    B, T, max_len = 2, 6, 16
    toks = _tokens(jcfg.vocab_size, B, T, seed=3)
    jcache, _ = JM.init_cache(jcfg, B, max_len)
    cache = M.init_cache(tcfg, B, max_len, device="cpu")
    if dtype == "float32":
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
        cache = {k: v.float() for k, v in cache.items()}
    jstep = jax.jit(lambda p, c, t, n: JM.decode_step(p, jcfg, c, t, n))
    offset = np.array([0, 3], np.int32)
    for t in range(T):
        cur = t + offset if per_slot else np.int32(t)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(cur))
        got, cache = M.decode_step(model, tcfg, cache,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   torch.as_tensor(cur))
        _logits_close(got, want, dtype)
        if dtype == "float32":
            np.testing.assert_array_equal(
                got[:, -1].argmax(-1).numpy(),
                np.asarray(jnp.argmax(want[:, -1], -1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch,layers", [("granite_3_2b", 3),
                                         ("llama3_2_1b", 2),
                                         ("llama3_2_1b", 6)])
def test_bf16_logit_gap_stays_inside_the_bar_with_depth(arch, layers, seed):
    """The bf16 forward's max |port - reference| / max |reference| at
    growing depth and three seeds (printed; ``-s`` shows it) stays inside
    the 2e-2 bar of :func:`_logits_close`."""
    jcfg, params, tcfg, model = lm_pair(arch, "bfloat16", seed=seed,
                                        num_layers=layers)
    toks = _tokens(jcfg.vocab_size, 2, 24)
    want, _ = JM.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = M.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want.astype(jnp.float32))
    gap = float(np.abs(got.float().numpy() - want).max()
                / np.abs(want).max())
    print(f"bf16 gap {arch} {layers} layers seed {seed}: {gap:.4f}")
    assert gap <= 2e-2


# the families ported later, at their SMOKE sizes
LATER_FAMILIES = ["dbrx_132b", "grok_1_314b", "llama3_2_vision_90b",
                  "whisper_tiny", "recurrentgemma_2b"]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"]
                         + LATER_FAMILIES)
def test_lm_numpy_round_trip_is_bitwise(arch):
    jcfg, params, _, model = lm_pair(arch)
    p = jax.tree.map(np.asarray, params)
    back = lm_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"]
                         + LATER_FAMILIES)
def test_init_matches_reference_shapes_dtypes_and_scales(arch):
    """The port's own random init (a torch.Generator, not jax.random):
    the reference's tree, shapes and float32 dtypes; its constant leaves
    exactly; its truncated-normal leaves at the reference's scale."""
    jcfg, params, tcfg, _ = lm_pair(arch)
    want = jax.tree.map(np.asarray, params)
    got = lm_to_numpy(M.init(tcfg, seed=0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
        if np.all(w == w.reshape(-1)[0]):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif "A_log" in name:     # log(1..H): float32 logs, to an ulp
            np.testing.assert_allclose(g, w, rtol=1.2e-7, err_msg=name)
        elif "b_dt" in name:      # softplus(b_dt) log-uniform in [1e-3, 0.1]
            dt = np.logaddexp(g, 0.0)
            assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1, name
        else:   # the reference's spread; |x| <= 2 scale, std 0.8796 scale
            assert 0.85 < g.std() / w.std() < 1.15, name
            assert np.abs(g).max() <= 2 * w.std() / 0.8796 * 1.1, name


def test_padded_vocabulary_takes_part_in_the_argmax():
    """As in the reference, the logits cover the padded vocabulary and the
    argmax runs over it (a quirk kept for parity, see ROADMAP.md)."""
    cfg = TCB.get_config("mamba2_130m")
    assert L.padded_vocab(cfg.vocab_size) == 50_432 > cfg.vocab_size
    tcfg = dataclasses.replace(TCB.get_config("llama3_2_1b", smoke=True),
                               vocab_size=200)
    model = M.init(tcfg, seed=0, device="cpu")
    logits, _ = M.forward(model, tcfg, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert logits.shape[-1] == 256


def _ref_shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_shapes(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", [a for a in TCB.ARCH_IDS
                                  if a in JCB.ARCH_IDS])
def test_every_config_builds_with_the_reference_tree(arch, smoke):
    """Every configuration of ``configs/``, SMOKE and full, builds on
    ``device="meta"`` (nothing allocated) with the reference's parameter
    tree: each stacked leaf's shape is the port's per-layer shape with the
    layer count in front (the reference's ``abstract_init``)."""
    from repro.configs import base as CB
    cfg = TCB.get_config(arch, smoke=smoke)
    model = M.build(cfg, device="meta")
    got, layers = {}, {}
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32, name
        if M.stacked(name):
            top, i, rest = name.split(".", 2)
            key = f"{top}.{rest}"
            assert got.setdefault(key, tuple(t.shape)) == tuple(t.shape)
            assert int(i) == layers.get(key, 0), name     # in layer order
            layers[key] = int(i) + 1
        else:
            got[name] = tuple(t.shape)
    got = {k: (layers[k],) + v if k in layers else v
           for k, v in got.items()}
    params, _ = JM.abstract_init(CB.get_config(arch, smoke=smoke))
    assert got == dict(_ref_shapes(params))


def test_ssm_prefill_length_must_fit_the_chunk():
    """Above the chunk, a prefill length must be a multiple of it (the
    reference asserts the same; nothing is padded)."""
    tcfg = TCB.get_config("mamba2_130m", smoke=True)
    model = M.init(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        M.forward(model, tcfg, {"tokens": torch.zeros((1, 40),
                                                      dtype=torch.int32)})


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        M.init(TCB.get_config("llama3_2_1b", smoke=True))

"""The port's moe, vlm, audio and hybrid families (``repro_torch.models``:
``moe``, the ``transformer`` branches, ``whisper``, ``rglru``, and
``layers``' local and cross attention) against the reference's
``repro.models`` on the same parameters and inputs, at the SMOKE sizes of
dbrx-132b and grok-1-314b (moe), llama-3.2-vision-90b (vlm), whisper-tiny
(audio) and recurrentgemma-2b (hybrid).

Parameters come from ``repro.models.model.init`` and are carried across by
``lm_from_numpy``; the vlm's tanh gates are set to ``VLM_GATES`` first (at
their init value 0 a cross block adds exactly nothing). Tokens, patches and
frames are made with numpy from a seed. Bars, as ``tests/test_torch_lm.py``:
float32 logits within atol 1e-4 / rtol 1e-4 and the same next token;
bfloat16 logits within 2e-2 x max |logits|; the moe aux losses (float32)
within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import whisper as JW
from repro_torch.configs import base as TCB
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import whisper as W

from _torch_state import VLM_GATES, lm_pair

F32 = dict(atol=1e-4, rtol=1e-4)
NEW = ["dbrx_132b", "grok_1_314b", "llama3_2_vision_90b", "whisper_tiny",
       "recurrentgemma_2b"]


def _pair(arch, dtype="float32", seed=0, **overrides):
    return lm_pair(arch, dtype, seed, gates=VLM_GATES, **overrides)


def _inputs(cfg, B, S, seed=1):
    """tokens and the family's stub input (unit-scale patches or frames),
    as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _logits_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _aux_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch,S,overrides", [
    ("dbrx_132b", 24, {}),
    ("grok_1_314b", 24, {}),
    ("dbrx_132b", 24, {"capacity_factor": 0.5}),     # capacity drops tokens
    ("llama3_2_vision_90b", 24, {}),
    ("whisper_tiny", 24, {}),
    ("recurrentgemma_2b", 12, {}),                    # S <= window: causal
    ("recurrentgemma_2b", 48, {}),                    # 3 windows: two-block
    ("recurrentgemma_2b", 32, {"num_layers": 5}),     # 1 group + 2 extra
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_step_match_reference(arch, S, overrides, dtype):
    jcfg, params, tcfg, model = _pair(arch, dtype, **overrides)
    batch = _inputs(jcfg, 2, S)
    want, jaux = JM.forward(params, jcfg, _j(batch))
    got, aux = M.forward(model, tcfg, _t(batch))
    assert got.dtype == getattr(torch, dtype)
    _logits_close(got, want, dtype)
    if dtype == "float32":
        _aux_close(aux, jaux)
        nxt = make_prefill_step(tcfg)(model, _t(batch))
        jnxt = jax_prefill_step(jcfg)(params, _j(batch))
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _filled_caches(jcfg, params, tcfg, model, B, max_len, dtype, seed=4):
    """Both packages' zero caches, float32 in the float32 runs, with the vlm
    context filled with patches and the audio ``enc_out`` with each side's
    own ``encode`` of the same frames."""
    jcache, _ = JM.init_cache(jcfg, B, max_len)
    cache = M.init_cache(tcfg, B, max_len, device="cpu")
    for k, v in jcache.items():   # the reference's layout and dtypes
        assert cache[k].dtype == getattr(torch, str(v.dtype)), k
        assert tuple(cache[k].shape) == v.shape, k
    if dtype == "float32":
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
        cache = {k: v.float() for k, v in cache.items()}
    extra = {k: v for k, v in _inputs(jcfg, B, 1, seed).items()
             if k != "tokens"}
    if "patches" in extra:
        p = extra["patches"]
        jcache["context"] = jnp.asarray(p, jcache["context"].dtype)
        cache["context"] = torch.from_numpy(p).to(cache["context"].dtype)
    if "frames" in extra:
        f = extra["frames"]
        jcache["enc_out"] = JW.encode(params, jcfg, jnp.asarray(f)).astype(
            jcache["enc_out"].dtype)
        cache["enc_out"] = W.encode(model, tcfg, torch.from_numpy(f)).to(
            cache["enc_out"].dtype)
    return jcache, cache


@pytest.mark.parametrize("arch,T,max_len", [
    ("dbrx_132b", 6, 16), ("llama3_2_vision_90b", 6, 16),
    ("whisper_tiny", 6, 16),
    ("recurrentgemma_2b", 22, 16),     # a one-window cache: it wraps
])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(arch, T, max_len, per_slot, dtype):
    """Teacher-forced decoding, every step's logits and next tokens, with a
    scalar ``cur_len`` or a per-slot (B,) one (slot 1 three positions
    ahead). The hybrid's cache is one window long (16), so its rolling
    buffer wraps after 16 tokens and the decode runs past it. float32 runs
    take float32 caches on both sides, bfloat16 runs the default ones (as
    ``tests/test_torch_lm.py`` explains)."""
    jcfg, params, tcfg, model = _pair(arch, dtype, seed=2)
    if jcfg.family == "hybrid":
        assert jcfg.attn_window == max_len
    B = 2
    toks = _inputs(jcfg, B, T, seed=3)["tokens"]
    jcache, cache = _filled_caches(jcfg, params, tcfg, model, B, max_len,
                                   dtype)
    fixed = {k: cache[k].clone() for k in ("context", "enc_out")
             if k in cache}
    jstep = jax.jit(lambda p, c, t, n: JM.decode_step(p, jcfg, c, t, n))
    step = make_decode_step(tcfg)
    offset = np.array([0, 3], np.int32)
    for t in range(T):
        cur = t + offset if per_slot else np.int32(t)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(cur))
        got, new_cache = M.decode_step(model, tcfg, cache,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       torch.as_tensor(cur))
        _logits_close(got, want, dtype)
        nxt, cache = step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                          torch.as_tensor(cur))
        assert all(torch.equal(cache[k], new_cache[k]) for k in cache)
        if dtype == "float32":
            np.testing.assert_array_equal(
                nxt.numpy(), np.asarray(jnp.argmax(want[:, -1:], -1)))
    # the context and the encoder output are read, never written
    assert all(torch.equal(cache[k], v) for k, v in fixed.items())


def test_hybrid_prefill_needs_a_multiple_of_the_window():
    """Above the window the two-block form needs S % window == 0 (the
    reference asserts it)."""
    _, _, cfg, model = _pair("recurrentgemma_2b")
    with pytest.raises(ValueError, match="multiple of the window"):
        M.forward(model, cfg, {"tokens": torch.zeros((1, 24),
                                                     dtype=torch.int32)})


def test_local_attention_is_chosen_by_the_window_alone(monkeypatch):
    """A layer with a window runs the plain local attention whatever the
    backend asks of the flash kernel (its wrapper, replaced here by a probe
    that raises, is called only without a window), and matches its
    two-block form against one materialised sliding-window mask."""
    _, _, cfg, model = _pair("recurrentgemma_2b")
    p = model.groups[0].attn.attn
    x = torch.randn(2, 48, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(48, dtype=torch.int32).expand(2, 48)

    def probe(*a, **kw):
        raise LookupError("the flash kernel's wrapper was called")
    monkeypatch.setattr(L.ops, "flash_attention", probe)
    got = L.attention_apply(p, x, cfg, positions=pos, window=16,
                            backend="torch")
    with pytest.raises(LookupError, match="wrapper was called"):
        L.attention_apply(p, x, cfg, positions=pos, backend="torch")
    q, k, v = L._project_qkv(p, x, pos, cfg.rope_theta)
    i, j = torch.arange(48)[:, None], torch.arange(48)[None, :]
    mask = (j <= i) & (i - j < 16)
    H = q.shape[2]
    ctx = L._sdpa(q, L._repeat_kv(k, H), L._repeat_kv(v, H), mask,
                  cfg.head_dim ** -0.5)
    want = torch.einsum("bshk,hkd->bsd", ctx, p.wo)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_moe_capacity_drops_like_the_reference():
    """With capacity factor 0.5 (6 slots per expert for 48 choices over 4
    experts) the router drops choices; which ones, the combine weights and
    the layer's output equal the reference's."""
    jcfg, params, tcfg, model = _pair("dbrx_132b", capacity_factor=0.5)
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["ffn"])
    want, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    p = model.blocks[0].ffn
    got, aux = MOE.moe_apply(p, torch.from_numpy(x), tcfg)
    _, _, _, keep, w_flat = MOE.route(p, torch.from_numpy(x), tcfg)
    assert MOE.capacity(tcfg, 24) == 6 and 0 < int((~keep).sum()) < 48 * 2
    assert bool((w_flat[~keep] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _aux_close(aux, jaux)


def test_top_k_orders_ties_like_jax():
    """``jax.lax.top_k`` puts the lower index first among equal values;
    so does ``moe.top_k``, on many ties."""
    g = np.random.default_rng(6).integers(0, 3, size=(4, 50, 8)).astype(
        np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(g), 3)
    tv, ti = MOE.top_k(torch.from_numpy(g), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_router_tie_matches_reference(dtype):
    """Experts 1 and 2 given the same router column: every token's gates
    tie between them, and the top-2 choice, the capacity assignment, the
    aux losses and the output follow the reference's order (expert 1
    first)."""
    jcfg, params, tcfg, model = _pair("dbrx_132b", dtype,
                                      capacity_factor=0.5)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["ffn"])
    r = np.array(jp["router"])
    r[:, 2] = r[:, 1]
    r[:, 1:3] *= 4.0               # make the pair win most tokens
    jp = dict(jp, router=jnp.asarray(r))
    p = model.blocks[0].ffn
    p.router.copy_(torch.from_numpy(r))
    x = np.random.default_rng(7).standard_normal((2, 24, 64)).astype(
        np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    _, flat_e, _, keep, _ = MOE.route(p, xt, tcfg)
    pairs = flat_e.reshape(2, 24, 2)
    tied = (pairs == torch.tensor([1, 2])).all(-1)
    assert int(tied.sum()) > 10 and not bool(
        (pairs == torch.tensor([2, 1])).all(-1).any())
    assert not bool(keep.all())
    want, jaux = JMOE.moe_apply(jp, xj, jcfg)
    got, aux = MOE.moe_apply(p, xt, tcfg)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        assert np.abs(got.float().numpy() - want).max() <= \
            2e-2 * np.abs(want).max()
    _aux_close(aux, jaux)


@pytest.mark.parametrize("arch", NEW)
def test_loss_fn_matches_reference(arch):
    """``loss_fn``: the next-token NLL plus, for the moe family, both aux
    losses with their ``AUX_COEFS`` weights over ``num_layers``."""
    jcfg, params, tcfg, model = _pair(arch)
    S = 32 if jcfg.family == "hybrid" else 24    # two windows
    batch = _inputs(jcfg, 2, S)
    batch["labels"] = _inputs(jcfg, 2, S, seed=8)["tokens"]
    want, jmet = JM.loss_fn(params, jcfg, _j(batch))
    got, met = M.loss_fn(model, tcfg, _t(batch))
    assert sorted(met) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if jcfg.family == "moe":
        nll = float(met["nll"]) - sum(
            c * float(met[k]) / jcfg.num_layers
            for k, c in M.AUX_COEFS.items())
        assert float(met["load_balance"]) > 0 and abs(nll) > 0


def test_vlm_gates_at_zero_add_nothing():
    """The reference's init leaves both tanh gates at 0: the cross blocks
    then add exactly nothing, whatever the patches."""
    _, _, cfg, model = lm_pair("llama3_2_vision_90b")
    assert all(float(cb.gate_attn) == float(cb.gate_mlp) == 0.0
               for cb in model.cross_blocks)
    batch = _t(_inputs(cfg, 2, 12))
    a, _ = M.forward(model, cfg, batch)
    b, _ = M.forward(model, cfg, dict(batch, patches=batch["patches"] * 7))
    assert torch.equal(a, b)
    model2 = lm_pair("llama3_2_vision_90b", gates=VLM_GATES)[3]
    c, _ = M.forward(model2, cfg, batch)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("arch", NEW + ["llama3_2_1b", "mamba2_130m"])
def test_cache_batch_dims_name_every_cache_tensor(arch):
    tcfg = TCB.get_config(arch, smoke=True)
    cache = M.init_cache(tcfg, 3, 8, device="meta")
    dims = M.cache_batch_dims(tcfg)
    assert set(cache) <= set(dims)
    assert all(t.shape[dims[k]] == 3 for k, t in cache.items())

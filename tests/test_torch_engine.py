"""The port's serving engine (``repro_torch.serve.engine``) against the
invariants of ``tests/test_engine_continuous.py``, on the CPU at the SMOKE
sizes: continuous batching reproduces single-request gold outputs across
slot reuse (the recurrent family needs the slot reset), long and short
requests interleave without a wave barrier, EOS stops a request, and the
wave scheduler gives the continuous one's outputs where no padding
differs. Also the ``launch.serve`` driver end to end.

The scheduler itself is held against the reference's
``repro.serve.engine.Engine`` on the same parameters and prompts, in both
modes, for every family (dense, ssm, moe, vlm, audio, hybrid): decode
steps, prefill and generated token counts, waves and completion order
exactly, and the tokens as far as the bf16 logits' margin decides them.
A slot's reset zeroes that slot alone along each cache tensor's own
batch dim.
"""
import pytest
import torch

from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import base as CB
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine

from _torch_state import VLM_GATES, lm_pair

PROMPTS = [[1, 2, 3], [7, 8], [4, 5, 6, 9], [2, 2], [11]]
NEW = [5, 3, 6, 2, 4]
SLOTS = 2
# the bf16 decode-step bar of tests/test_torch_lm.py: the two packages'
# logits agree within BF16_BAR x max |logits|
BF16_BAR = 2e-2


def _model(arch, seed=0):
    cfg = CB.get_config(arch, smoke=True)
    return cfg, M.init(cfg, seed=seed, device="cpu")


def _gold(cfg, model, prompt, n):
    """One request alone in a 1-slot engine = ground truth (no padding)."""
    eng = Engine(cfg, model, batch_slots=1, max_len=64, mode="continuous")
    r = eng.submit(prompt, max_new_tokens=n)
    eng.run()
    return r.output


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"])
def test_continuous_matches_single_request_gold(arch):
    cfg, model = _model(arch)
    gold = [_gold(cfg, model, p, 5) for p in PROMPTS]

    # 2 slots, 5 requests -> slots are necessarily reused mid-flight
    eng = Engine(cfg, model, batch_slots=2, max_len=64, mode="continuous")
    reqs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    eng.run()
    for r, g in zip(reqs, gold):
        assert r.output == g, (r.uid, r.output, g)
    assert all(r.done for r in reqs)
    assert eng.stats.generated_tokens == 5 * len(PROMPTS)
    assert eng.stats.prefill_tokens == sum(map(len, PROMPTS))


def test_continuous_interleaves_lengths():
    """Very different prompt/output lengths share the batch without a wave
    barrier: total decode steps is far below the wave schedule's bound."""
    cfg, model = _model("llama3_2_1b", seed=1)
    eng = Engine(cfg, model, batch_slots=2, max_len=64, mode="continuous")
    eng.submit([1] * 20, max_new_tokens=2)
    eng.submit([2], max_new_tokens=2)
    eng.submit([3], max_new_tokens=2)
    eng.run()
    # wave mode would take ceil(3/2)=2 waves x (20 prefill + 2 decode) = 44;
    # continuous: long prefill overlaps the two short requests
    assert eng.stats.decode_steps <= 30


def test_eos_stops_early():
    cfg, model = _model("llama3_2_1b")
    eng = Engine(cfg, model, batch_slots=1, max_len=64, mode="continuous")
    probe = eng.submit([1, 2, 3], max_new_tokens=8)
    eng.run()
    first = probe.output[0]
    eng2 = Engine(cfg, model, batch_slots=1, max_len=64, mode="continuous")
    r = eng2.submit([1, 2, 3], max_new_tokens=8, eos_id=first)
    eng2.run()
    assert r.output == [first]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"])
def test_wave_matches_continuous_on_equal_length_prompts(arch):
    """With prompts of one length per wave there is no left padding, so the
    wave scheduler must give the continuous scheduler's outputs."""
    cfg, model = _model(arch, seed=3)
    prompts = [[5, 6, 7], [9, 1, 4], [3, 3, 8], [10, 2, 6]]
    outs = {}
    for mode in ("wave", "continuous"):
        eng = Engine(cfg, model, batch_slots=2, max_len=64, mode=mode)
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        outs[mode] = [r.output for r in reqs]
        assert all(len(o) == 4 for o in outs[mode])
    assert outs["wave"] == outs["continuous"]


def test_engine_serves_bf16_and_leaves_the_model_as_it_is():
    cfg, model = _model("mamba2_130m")
    eng = Engine(cfg, model, batch_slots=2, max_len=32)
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert Engine(cfg, eng.model).model is eng.model    # already bf16
    with pytest.raises(ValueError, match="unknown engine mode"):
        Engine(cfg, model, mode="beam")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 30, max_new_tokens=8)
        eng.run()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "dbrx-132b",
                                  "llama-3.2-vision-90b", "whisper-tiny",
                                  "recurrentgemma-2b"])
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3 requests in 0 waves" in out and "generated 12 tok" in out


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m", "dbrx_132b",
                                  "llama3_2_vision_90b", "whisper_tiny",
                                  "recurrentgemma_2b"])
def test_reset_slot_zeroes_only_that_slot(arch):
    """A slot's reset zeroes that slot along each cache tensor's own batch
    dim and touches nothing else: dim 1 of the stacked per-layer caches,
    dim 0 of the vlm ``context`` and the audio ``enc_out``."""
    cfg, model = _model(arch)
    eng = Engine(cfg, model, batch_slots=3, max_len=16)
    cache = M.init_cache(cfg, 3, 16, device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype) + 3)
    before = {k: t.clone() for k, t in cache.items()}
    eng._reset_slot(cache, 1)
    dims = M.cache_batch_dims(cfg)
    for k, t in cache.items():
        d = dims[k]
        assert not bool(t.select(d, 1).any()), k
        for s in (0, 2):
            assert torch.equal(t.select(d, s), before[k].select(d, s)), k
    assert ("context" in cache) == (cfg.family == "vlm")
    assert ("enc_out" in cache) == (cfg.family == "audio")


def _serve(engine_cls, cfg, params, mode, eos=None):
    """PROMPTS through one engine: (requests, uids in completion order,
    stats)."""
    eng = engine_cls(cfg, params, batch_slots=SLOTS, max_len=32, mode=mode)
    reqs = [eng.submit(p, max_new_tokens=n,
                       eos_id=None if eos is None else eos[i])
            for i, (p, n) in enumerate(zip(PROMPTS, NEW))]
    done = eng.run()
    s = eng.stats
    return reqs, [r.uid for r in done], (s.waves, s.decode_steps,
                                         s.prefill_tokens, s.generated_tokens)


def _fed(mode, i):
    """The tokens slot ``i``'s request is fed before its first output: its
    prompt, left-padded with 0 to its wave's longest prompt in wave mode."""
    if mode == "continuous":
        return PROMPTS[i]
    wave = PROMPTS[i - i % SLOTS:i - i % SLOTS + SLOTS]
    return [0] * (max(map(len, wave)) - len(PROMPTS[i])) + PROMPTS[i]


def _port_logits(cfg, model, seq):
    """The port's bf16 logits after ``seq``, fed one token at a time through
    the decode step of a 1-slot cache, as the engine feeds a slot."""
    model = M.cast(model, cfg, torch.bfloat16)
    cache = M.init_cache(cfg, 1, len(seq) + 1, device="cpu")
    for t, tok in enumerate(seq):
        logits, cache = M.decode_step(
            model, cfg, cache, torch.tensor([[tok]], dtype=torch.int32),
            torch.tensor(t, dtype=torch.int32))
    return logits[0, -1].float()


def _tokens_agree(cfg, model, mode, jreqs, treqs) -> bool:
    """Each request's tokens are equal up to the first place they part.
    There the port's logits may favour its own token over the reference's
    by at most twice the bf16 bar (each side's logit can be off by one bar),
    else the two packages would have had to pick the same token. Returns
    whether every request's tokens were equal."""
    same = True
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        for k, (want, got) in enumerate(zip(jr.output, tr.output)):
            if want != got:
                lg = _port_logits(cfg, model, _fed(mode, i) + tr.output[:k])
                gap = float(lg[got] - lg[want])
                bar = 2 * BF16_BAR * float(lg.abs().max())
                assert 0 <= gap <= bar, (i, k, want, got, gap, bar)
                same = False
                break
        else:
            assert len(jr.output) == len(tr.output), (i, jr.output,
                                                      tr.output)
    return same


@pytest.mark.parametrize("mode", ["continuous", "wave"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m", "dbrx_132b",
                                  "llama3_2_vision_90b", "whisper_tiny",
                                  "recurrentgemma_2b"])
def test_engine_schedules_like_the_reference(arch, mode):
    """Without EOS the schedule depends only on the prompts and budgets:
    the port's stats and completion order equal the reference's exactly,
    across slot reuse (5 requests, 2 slots, mixed lengths). For every
    family: the vlm with its gates set (its context stays zeros in both
    engines), the hybrid's cache one window long, so long requests wrap
    it."""
    jcfg, params, tcfg, model = lm_pair(arch, "bfloat16", gates=VLM_GATES)
    jreqs, jorder, jstats = _serve(JaxEngine, jcfg, params, mode)
    treqs, torder, tstats = _serve(Engine, tcfg, model, mode)
    assert tstats == jstats
    assert torder == jorder
    assert all(r.done and len(r.output) == n for r, n in zip(treqs, NEW))
    _tokens_agree(tcfg, model, mode, jreqs, treqs)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_130m"])
def test_engine_stops_on_eos_like_the_reference(arch, mode):
    """Each request's EOS is the reference's second token of a run without
    EOS, so the reference stops every request after at most two tokens.
    Where the two packages' tokens agree, the port stops at the same places,
    with the same stats and completion order."""
    jcfg, params, tcfg, model = lm_pair(arch, "bfloat16")
    eos = [r.output[1] for r in _serve(JaxEngine, jcfg, params, mode)[0]]
    jreqs, jorder, jstats = _serve(JaxEngine, jcfg, params, mode, eos)
    treqs, torder, tstats = _serve(Engine, tcfg, model, mode, eos)
    assert all(len(r.output) <= 2 and r.output[-1] == e
               for r, e in zip(jreqs, eos))
    if _tokens_agree(tcfg, model, mode, jreqs, treqs):
        assert tstats == jstats
        assert torder == jorder

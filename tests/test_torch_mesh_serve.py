"""Serving on a mesh (``Engine(mesh=...)``, ``launch.steps.
place_decode_args``, ``layers.decode_attention`` on a seq-sharded cache):
a (2, 2) ``("data", "model")`` mesh of 4 ``gloo`` ranks, in one spawn that
serves every family in turn (``tests/_mesh_ranks.serve_each``).

- The reference's ``Engine`` on the Auto-axis (2, 2) mesh of 4 forced
  host devices against the port's, from the reference's params carried
  across (llama3.2-1b, mamba2-130m, recurrentgemma-2b), both modes, the
  prompts of ``tests/test_torch_engine.py`` (5 requests on 2 slots, so
  slots are reused): stats and completion order exactly, tokens by the
  bf16 margin rule.
- The port's mesh engine against its ``mesh=None`` engine for all six
  families (dense, ssm, moe, vlm with its gates set, audio, hybrid): the
  same, every rank's outputs equal to rank 0's, and the decode step
  returning the cache with the placements it was given.
- ``decode_attention`` on a cache split over slots and sequence against
  the function on whole tensors: float32 within 1e-6 of max |out|,
  bfloat16 within the bf16 decode bar; no all-gather.
- ``_reset_slot`` on batch-sharded caches zeroes the slot alone, on the
  ranks that hold it, with no collective.
- The SMOKE llama3.2-1b decode cell traced on a fake (4, 2) ``cpu`` mesh
  under the op counter gathers nothing as large as its scores; the
  ``mesh=None`` decode step's logits are those of the function before
  the sharded path existed, bit for bit.

The token rule (``tests/test_torch_engine.py::_tokens_agree``): each
request's tokens are equal up to the first place they part; there the
mesh run's own bf16 logits (the same fed tokens through a 1-slot cache on
the mesh) may favour its token over the other by at most 2 x 2e-2 x max
|logit|.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

import _mesh_ranks as R
from _torch_state import VLM_GATES, one_torch_thread  # noqa: F401
from test_torch_engine import NEW, PROMPTS, SLOTS

REPO = pathlib.Path(__file__).resolve().parent.parent
MAX_LEN = 32
WITH_REF = ("llama3_2_1b", "mamba2_130m", "recurrentgemma_2b")
ALL = WITH_REF + ("dbrx_132b", "llama3_2_vision_90b", "whisper_tiny")
MODES = ("continuous", "wave")
JOB = dict(prompts=PROMPTS, new=NEW, slots=SLOTS, max_len=MAX_LEN)


def _port_init(arch):
    """The port's seed-0 SMOKE params (port names -> numpy), the vlm's
    cross-block gates set to ``VLM_GATES``."""
    from repro_torch.models import model as M
    model = M.init(R._cfg(arch, "bfloat16"), seed=0, device="cpu")
    out = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    for k in out:
        if k.endswith(".gate_attn"):
            out[k][...] = VLM_GATES[0]
        elif k.endswith(".gate_mlp"):
            out[k][...] = VLM_GATES[1]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh engines and the port's ranks, side by side in
    two subprocesses from the same params: the ranks serve every family,
    then read the reference's runs when they appear and find where their
    tokens part from them."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    ref_params = {arch: R.reference_params(arch) for arch in WITH_REF}
    ref = R.start_reference_serve(REPO, tmp, dict(JOB, params=ref_params))
    cases = [dict(arch=arch, params=R.port_names(arch, "bfloat16",
                                                ref_params[arch])
                  if arch in ref_params else _port_init(arch))
             for arch in ALL]
    port = R.start_ranks(REPO, tmp, "serve_each", 4,
                         dict(JOB, cases=cases, ref_out=str(ref[1])), "serve")
    assert R.finish(ref)["devices"] == 4
    out = R.finish(port)
    assert out["world"] == 4 and out["reference_devices"] == 4
    out["by_arch"] = {c["arch"]: c for c in out["cases"]}
    return out


def _hold_tokens(parts):
    """Each request's first parting within the margin rule; returns
    whether every request's tokens were equal."""
    for p in parts:
        if p is not None:
            i, k, got, want, gap, bar = p
            assert k >= 0, ("lengths differ", p)
            assert 0 <= gap <= bar, p
    return all(p is None for p in parts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", WITH_REF)
def test_mesh_engine_matches_the_reference_mesh_engine(runs, arch, mode):
    rec = runs["by_arch"][arch]["modes"][mode]
    outs, order, stats = rec["mesh"]
    ref_outs, ref_order, ref_stats = rec["ref"]
    assert stats == ref_stats
    assert order == ref_order
    assert [len(o) for o in outs] == NEW
    _hold_tokens(rec["vs_ref"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ALL)
def test_mesh_engine_matches_one_device(runs, arch, mode):
    case = runs["by_arch"][arch]
    rec = case["modes"][mode]
    assert rec["mesh"][2] == rec["none"][2]        # stats
    assert rec["mesh"][1] == rec["none"][1]        # completion order
    assert all(r == rec["every_rank"][0] for r in rec["every_rank"])
    assert rec["every_rank"][0] == rec["mesh"]
    _hold_tokens(rec["vs_none"])
    for name, (given, returned) in case["cache_placements"].items():
        assert returned == given, (name, given, returned)
    # the slots over data and, for the attention caches, the sequence
    # over model
    seq = {k: g for k, (g, _) in case["cache_placements"].items()
           if k in ("k", "v")}
    assert all(any(p.is_shard(2) for p in g) for g in seq.values()), seq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", ["per slot", "scalar"])
def test_decode_attention_on_a_seq_sharded_cache(runs, dtype, lens):
    rec = runs["decode_attention"][(dtype, lens)]
    bar = 1e-6 if dtype == "float32" else R.BF16_BAR
    assert rec["err"] <= bar * rec["max_abs"], rec
    assert rec["dtype"] == f"torch.{dtype}"
    assert not any("gather" in c for c in rec["comms"]), rec["comms"]
    # the max, the sum and the output over model: three all-reduces
    assert sum(n for c, n in rec["comms"].items()
               if "all_reduce" in c) == 3, rec["comms"]


@pytest.mark.parametrize("arch", ALL)
def test_reset_slot_zeroes_the_slot_on_the_ranks_that_hold_it(runs, arch):
    rec = runs["reset"][arch]
    assert rec["sharded"], "every cache tensor's slots over data"
    assert rec["whole"] and rec["local"], rec
    assert rec["comms"] == {}, rec["comms"]


def test_engine_on_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.configs import base as CB
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    cfg = CB.get_config("llama3_2_1b", smoke=True)
    model = M.init(cfg, seed=0, device="cpu")
    mesh = types.SimpleNamespace(device_type="cuda",
                                 mesh_dim_names=("data", "model"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine(cfg, model, mesh=mesh)


# ---------------------------------------------------------------------------
# the decode cell under the op counter, and mesh=None unchanged
# ---------------------------------------------------------------------------


def _decode_attention_before(q, cache_k, cache_v, cur_len):
    """``layers.decode_attention`` as it stood before its seq-sharded path:
    the reference's ops on whatever tensors it is given (a ``DTensor``'s
    softmax over its sharded sequence gathers the scores)."""
    from repro_torch.distributed.sharding import constrain
    from repro_torch.kernels.ref import repeat_kv
    B, _, H, hd = q.shape
    S = cache_k.shape[1]
    k = repeat_kv(cache_k, H)
    v = repeat_kv(cache_v, H)
    s = torch.einsum("bqhk,bshk->bhqs", q, k).float() / math.sqrt(hd)
    s = constrain(s, "batch", None, None, "seq_shard")
    lens = cur_len.reshape(-1, 1, 1, 1)
    valid = torch.arange(S, device=q.device)[None, None, None, :] < lens
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", p, v)


_CELL = r"""
import json, sys
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import base as CB
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import layers as L
import test_torch_mesh_serve as T

mesh = make_fake_mesh((4, 2), ("data", "model"), device="cpu")
cfg = CB.get_config("llama3.2-1b", smoke=True)
shape = CB.ShapeConfig("t", int(sys.argv[1]), 8, "decode")
out = {"layers": cfg.num_layers, "heads": cfg.num_heads}
for name, fn in (("now", L.decode_attention),
                 ("before", T._decode_attention_before)):
    L.decode_attention = fn
    with FakeTensorMode():
        spec = ST.build_cell(cfg, shape, mesh)
        c = DR.count_step(spec, mesh)
    out[name] = {"collective_bytes": c.summary.collective_bytes,
                 "hbm_bytes": c.summary.hbm_bytes,
                 "collectives": [(x["op"], x["out_bytes"])
                                 for x in c.summary.collectives]}
print(json.dumps(out))
"""


def test_decode_cell_on_a_fake_4x2_mesh_gathers_no_scores():
    """The SMOKE llama3.2-1b decode cell (8 slots, a 4,096-deep cache) on a
    fake (4, 2) mesh: no all-gather has an output as large as a rank's
    (2, H, 1, 4096) float32 scores (a layer's cache, gathered, would be
    larger still), while the function before the sharded path gathers
    them in every layer (the check sees what it looks for); the max and
    the sum are all-reduced once each a layer."""
    S = 4096
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CELL, str(S)],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    scores = (8 // 4) * out["heads"] * 1 * S * 4

    def gathers(run):
        return [b for op, b in out[run]["collectives"] if "all_gather" in op]
    assert max(gathers("now")) < scores, gathers("now")
    assert sum(b >= scores for b in gathers("before")) >= out["layers"]
    stats = (8 // 4) * out["heads"] * 4          # (2, H, 1, 1) float32
    reduces = [b for op, b in out["now"]["collectives"]
               if "all_reduce" in op]
    assert reduces.count(stats) == 2 * out["layers"], reduces
    assert out["now"]["collective_bytes"] < out["before"]["collective_bytes"]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "recurrentgemma_2b",
                                  "whisper_tiny"])
def test_mesh_none_decode_step_is_unchanged(arch, monkeypatch):
    """Without a mesh, three bf16 decode steps of 3 slots (per-slot
    lengths, the hybrid's rolling window wrapped) give the logits and
    cache of the function before the sharded path, bit for bit."""
    from repro_torch.configs import base as CB
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = CB.get_config(arch, smoke=True)
    model = M.cast(M.init(cfg, seed=0, device="cpu"), cfg)

    def steps():
        cache = M.init_cache(cfg, 3, 24, device="cpu")
        cur = torch.tensor([0, 15, 21], dtype=torch.int32)
        outs = []
        for t in range(3):
            tok = torch.tensor([[5 + t], [9], [t]], dtype=torch.int32)
            logits, cache = M.decode_step(model, cfg, cache, tok, cur + t)
            outs.append(logits)
        return outs, cache

    now, cache_now = steps()
    monkeypatch.setattr(L, "decode_attention", _decode_attention_before)
    before, cache_before = steps()
    assert all(torch.equal(a, b) for a, b in zip(now, before))
    assert all(torch.equal(cache_now[k], cache_before[k]) for k in cache_now)

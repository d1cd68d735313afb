"""Training the moe, vlm, audio and hybrid families as the card trains them
(``chip_smoke.py`` phase 18), on the CPU:

- the vlm cuts that keep one cross block (``num_layers=1,
  cross_attn_every=1``, and the card's ``num_layers=3,
  cross_attn_every=3``) at SMOKE width, 3 float32 steps against the
  reference's jitted step with the same cut, at ``test_torch_train_step``'s
  float32 bars;
- dbrx-132b with bfloat16 Adam moments (``OptHParams(state_dtype=
  "bfloat16")``, the card's choice) against the reference's step with the
  same hparams, its update cut into pieces (``kernels.adamw.UPDATE_PIECE``
  made small); the piecewise update bit for bit the whole one;
- the flash launches and backward recomputes a train step derives from
  the config (``chip_smoke.per_train_step``), and the selective scan's
  forward and backward launches (``chip_smoke.scan_launches``), against
  the calls of the kernels' Functions on the CPU's plain path, every
  family;
- each card configuration chosen from the dry-run's prediction
  (``chip_smoke.choose_train_cut``: the train step traced on a fake (1, 1)
  ``cpu`` mesh, or as one card runs it for granite and jamba, arguments
  plus peak temporaries) at most 72 GB, in a
  subprocess (a process group must not outlive its test).

Bars of the bf16-moment test: metrics and parameters at the float32 bars
(the activations are float32); the moments, bfloat16 in both packages,
within bf16's unit roundoff (2**-8) of each tensor's largest moment [1.6e-3
x that max, m at step 3] and bitwise equal in at least 99% of elements
[99.77%]: an element whose float32 moment lands on the other side of a
bf16 rounding boundary in the two packages takes the neighbouring value.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_train_step as TS
from repro_torch.configs import base as CB
from repro_torch.convert import opt_state_to_numpy
from repro_torch.data import pipeline as DP
from repro_torch.kernels import adamw as AW
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import selective_scan as ss_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT

from _torch_state import lm_pair, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

VLM_CUT = dict(num_layers=1, cross_attn_every=1)
# the vlm cut the dry-run's prediction chooses for the card: three self
# blocks and their cross block
VLM_CARD_CUT = dict(num_layers=3, cross_attn_every=3)
# what the dry-run's prediction chooses for the card: (depth, Adam moments)
CARD_CUTS = {"dbrx-132b": (1, "bfloat16"),
             "llama-3.2-vision-90b": (3, "bfloat16"),
             "whisper-tiny": (4, "float32"),
             "recurrentgemma-2b": (26, "bfloat16"),
             "granite-4.0-h-small": (10, "float32"),
             "jamba2-3b": (28, "float32")}


@pytest.mark.parametrize("cut", [VLM_CUT, VLM_CARD_CUT],
                         ids=["1+1", "2+1"])
def test_vlm_cut_keeps_one_cross_block_in_both_packages(cut):
    jcfg, params, tcfg, model = lm_pair("llama3_2_vision_90b", **cut)
    assert len(model.blocks) == cut["num_layers"]
    assert len(model.cross_blocks) == 1
    assert params["cross_blocks"]["gate_attn"].shape[0] == 1
    full = CB.get_config("llama-3.2-vision-90b")
    got = chip_smoke.train_cut(full, cut["num_layers"])
    assert (got.num_layers, got.cross_attn_every) \
        == (cut["num_layers"], cut["cross_attn_every"])
    assert got.d_model == full.d_model and got.num_heads == full.num_heads


@pytest.mark.parametrize("cut", [VLM_CUT, VLM_CARD_CUT],
                         ids=["1+1", "2+1"])
def test_vlm_cut_train_steps_match_reference(cut):
    TS._check_float32("llama3_2_vision_90b", 32, 1, overrides=cut)


@pytest.fixture
def small_pieces(monkeypatch):
    """``apply_updates`` cuts every tensor above 257 elements into pieces."""
    monkeypatch.setattr(AW, "UPDATE_PIECE", 257)


def test_dbrx_bfloat16_moments_match_reference(small_pieces):
    gaps, equal, total = {"m": 0.0, "v": 0.0}, 0, 0
    for n, jm, m, jp, tp, jstate, state in TS._run(
            "dbrx_132b", 32, "float32", state_dtype="bfloat16"):
        for k in jm:
            assert TS._rel(m[k], jm[k]) <= 1e-5, (n, k)
        want, got = TS._leaves(jp), TS._leaves(tp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=5e-5, err_msg=f"{n} {k}")
        assert all(t.dtype == torch.bfloat16
                   for part in ("m", "v") for t in state[part].values())
        ts = opt_state_to_numpy(state)
        for part in ("m", "v"):
            w, g = TS._leaves(jstate[part]), TS._leaves(ts[part])
            for k in w:
                scale = np.abs(w[k]).max()
                gap = float(np.abs(g[k] - w[k]).max())
                gaps[part] = max(gaps[part], gap / scale if scale else gap)
                assert gap <= 2.0 ** -8 * scale, (n, part, k, gap, scale)
                equal += int((g[k] == w[k]).sum())
                total += w[k].size
    print(f"dbrx-132b bf16 moments: largest gap / tensor max {gaps}; "
          f"bitwise equal {equal / total:.5f}")
    assert equal >= 0.99 * total


def test_piecewise_update_is_the_whole_update_bit_for_bit(monkeypatch):
    """``apply_updates`` on (300, 70) tensors whole and in pieces of 1,000
    elements (a strided gradient keeps them whole): the parameters and both
    moments equal bit for bit, with float32 and bfloat16 moments."""
    def state(sd, strided):
        gen = torch.Generator().manual_seed(0)
        p = {"blocks.0.w": torch.randn((300, 70), generator=gen),
             "final_norm": torch.randn(70, generator=gen)}
        g = {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
        if strided:
            g["blocks.0.w"] = g["blocks.0.w"].t().contiguous().t()
        st = OPT.init_state(p, OPT.OptHParams(state_dtype=sd))
        for part in ("m", "v"):
            for v in st[part].values():
                v.copy_(torch.rand(v.shape, generator=gen))
        return p, g, st

    for sd in ("float32", "bfloat16"):
        hp = OPT.OptHParams(state_dtype=sd, warmup_steps=1)
        for strided, pieces in ((False, 21), (True, 1)):
            whole = state(sd, strided)
            OPT.apply_updates(*whole, hp)
            monkeypatch.setattr(AW, "UPDATE_PIECE", 1000)
            run = state(sd, strided)
            assert len(list(AW.pieces(run[0]["blocks.0.w"],
                                      run[1]["blocks.0.w"]))) == pieces
            OPT.apply_updates(*run, hp)
            monkeypatch.undo()
            for a, b in ((whole[0], run[0]), (whole[2]["m"], run[2]["m"]),
                         (whole[2]["v"], run[2]["v"])):
                for k in a:
                    assert torch.equal(a[k], b[k]), (sd, strided, k)


# SMOKE configs of every family, and the vlm at the card's cut
COUNT_CASES = [("llama3.2-1b", {}), ("mamba2-130m", {}), ("dbrx-132b", {}),
               ("llama-3.2-vision-90b", {}), ("llama-3.2-vision-90b", VLM_CUT),
               ("llama-3.2-vision-90b", VLM_CARD_CUT), ("whisper-tiny", {}),
               ("recurrentgemma-2b", {}), ("granite-4.0-h-small", {}),
               ("jamba2-3b", {})]


@pytest.mark.parametrize("arch,cut", COUNT_CASES,
                         ids=[f"{a}{'-%d+1' % c['num_layers'] if c else ''}"
                              for a, c in COUNT_CASES])
def test_derived_kernel_calls_per_train_step(arch, cut, monkeypatch):
    """A train step's forward and backward on the CPU's plain path
    (``backend="torch"``: the kernels' plain versions through the same
    wrappers and Functions as the card's) calls each kernel's ``_forward``
    as often as the card launches it, and each Function's backward once a
    layer: both as ``per_train_step`` derives them."""
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32", **cut)
    calls = {"flash_attention": 0, "ssd_scan": 0, "selective_scan": 0,
             "selective_scan_backward": 0}
    for name, mod, fn in (("flash_attention", fa_mod, "_forward"),
                          ("ssd_scan", ssd_mod, "_forward"),
                          ("selective_scan", ss_mod, "_forward"),
                          ("selective_scan_backward", ss_mod,
                           "selective_scan_backward_plain")):
        def counting(*a, _orig=getattr(mod, fn), _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, counting)
    fa_mod.reset_launches()
    ssd_mod.reset_launches()
    model = M.init(cfg, seed=0, device="cpu").requires_grad_(True)
    chip_smoke.set_vlm_gates(torch, model)
    b = DP.make_pipeline(cfg, seq_len=64, global_batch=2).batch_at(0)
    loss, _ = M.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                     for k, v in b.items()}, backend="torch")
    loss.backward()
    for name, mod in (("flash_attention", fa_mod), ("ssd_scan", ssd_mod)):
        assert (calls[name], mod.backward_recomputes[name]) \
            == chip_smoke.per_train_step(cfg, name), name
        assert mod.launches[name] == 0
    assert {k: calls[k] for k in ss_mod.launches} \
        == chip_smoke.scan_launches(cfg)
    assert sum(calls.values()) > 0 or cfg.family == "hybrid"


PREDICT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
import chip_smoke
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh((1, 1), ("data", "model"), device="cpu")
out = {{arch: chip_smoke.choose_train_cut(torch, arch, seq, mesh)
        for arch, seq in chip_smoke.FAMILY_TRAIN}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    out = tmp_path_factory.mktemp("predict") / "out.json"
    code = PREDICT.format(root=str(ROOT), src=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", sorted(CARD_CUTS))
def test_card_configuration_is_predicted_within_budget(arch, predictions):
    """The cut the card trains, chosen by the dry-run's prediction (the
    deepest, float32 moments before bfloat16), holds at most 72 GB of
    arguments and peak temporaries; widths, heads, experts, vocabulary and
    tokens as published (a hybrid_moe cut holds an ``EXPERT_SHARE``-th of
    the experts the router scores); its flash nodes as ``per_train_step``
    derives."""
    rec = predictions[arch]
    assert (rec["depth"], rec["state_dtype"]) == CARD_CUTS[arch]
    assert rec["predicted_bytes"] == rec["args_bytes"] + rec["temp_bytes"]
    assert rec["predicted_bytes"] <= chip_smoke.TRAIN_BUDGET_BYTES == 72e9
    full = CB.get_config(arch)
    cfg = chip_smoke.train_cut(full, rec["depth"])
    for field in ("d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "num_router_experts", "num_experts_per_tok"):
        assert getattr(cfg, field) == getattr(full, field)
    assert cfg.num_experts == (
        full.num_experts // chip_smoke.EXPERT_SHARE
        if full.family == "hybrid_moe" else full.num_experts)
    assert rec["seq"] == dict(chip_smoke.FAMILY_TRAIN)[arch]
    assert rec["flash_nodes"] == chip_smoke.per_train_step(cfg)[0]
    assert rec["bound_ms"] > 0
    # every candidate traced before it was predicted above the budget
    for cand in rec["tried"][:-1]:
        assert cand["predicted_gb"] > 72, cand
    print(f"{arch}: {json.dumps(rec)}")

"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``): the same ``(seed, index)`` gives the
same batch bit for bit, for the llama, vlm and audio SMOKE configs, through
``skip_to`` and host sharding; and the twins of the four data tests of
``tests/test_train_infra.py``."""
import numpy as np
import pytest

from repro.configs import base as CB
from repro.data import pipeline as JDP
from repro_torch.configs import base as TCB
from repro_torch.data import pipeline as DP


@pytest.mark.parametrize("arch", ["llama3_2_1b", "llama3_2_vision_90b",
                                  "whisper_tiny"])
@pytest.mark.parametrize("num_hosts,host_id", [(1, 0), (2, 1)])
def test_pipeline_is_bit_equal_to_reference(arch, num_hosts, host_id):
    kw = dict(seq_len=24, global_batch=4, seed=7, num_hosts=num_hosts,
              host_id=host_id)
    ref = JDP.make_pipeline(CB.get_config(arch, smoke=True), **kw)
    got = DP.make_pipeline(TCB.get_config(arch, smoke=True), **kw)
    np.testing.assert_array_equal(got.ngrams, ref.ngrams)
    ref.skip_to(5)
    got.skip_to(5)
    for _ in range(3):
        want, have = next(ref), next(got)
        assert sorted(have) == sorted(want)
        for k in want:
            assert have[k].dtype == want[k].dtype
            np.testing.assert_array_equal(have[k], want[k])
    assert got.index == ref.index == 8


# ---------------------------------------------------------------------------
# twins of tests/test_train_infra.py's data tests
# ---------------------------------------------------------------------------


def test_data_deterministic_and_seekable():
    cfg = TCB.get_config("llama3_2_1b", smoke=True)
    p1 = DP.make_pipeline(cfg, seq_len=16, global_batch=4, seed=1)
    p2 = DP.make_pipeline(cfg, seq_len=16, global_batch=4, seed=1)
    b0, b1 = next(p1), next(p1)
    p2.skip_to(1)
    np.testing.assert_array_equal(next(p2)["tokens"], b1["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_data_labels_are_shifted_tokens():
    cfg = TCB.get_config("llama3_2_1b", smoke=True)
    b = DP.make_pipeline(cfg, seq_len=16, global_batch=2).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_host_sharding_partitions_batch():
    cfg = TCB.get_config("llama3_2_1b", smoke=True)
    full = DP.make_pipeline(cfg, seq_len=8, global_batch=4).batch_at(0)
    parts = [DP.make_pipeline(cfg, seq_len=8, global_batch=4, num_hosts=2,
                              host_id=h).batch_at(0) for h in (0, 1)]
    stacked = np.concatenate([p["tokens"] for p in parts])
    np.testing.assert_array_equal(stacked, full["tokens"])


def test_data_modality_stubs():
    vlm = TCB.get_config("llama3_2_vision_90b", smoke=True)
    b = DP.make_pipeline(vlm, seq_len=8, global_batch=2).batch_at(0)
    assert b["patches"].shape == (2, vlm.num_patches, vlm.d_model)
    aud = TCB.get_config("whisper_tiny", smoke=True)
    b = DP.make_pipeline(aud, seq_len=8, global_batch=2).batch_at(0)
    assert b["frames"].shape == (2, aud.encoder_seq, aud.d_model)

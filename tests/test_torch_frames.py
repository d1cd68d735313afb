"""The port's frame codecs (``repro_torch.serve.frames``), twin of
``tests/test_frames.py``: partial reads across frame boundaries,
oversized-frame rejection, PFC1 tensor round-trip bit-identity for float64
shard payloads, codec negotiation down to an older json-only protocol-1
worker, and negotiated deflate frame compression (threshold behavior,
bomb-guarded inflation, bit-identity through the compressed wire). The wire
format is the reference's byte for byte: the port's frames, codecs and
HELLO bodies give the reference's bytes for the same values, and each side
decodes the other's."""
import numpy as np
import pytest

from repro.serve import frames as ref_frames
from repro_torch.serve import frames
from repro_torch.serve.shard import ShardPlane, WorkerServer

from _torch_state import carry_oracle


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def test_decoder_handles_partial_reads_across_boundaries():
    wire = (frames.encode_frame(frames.OP_HELLO, b"hello-body")
            + frames.encode_frame(frames.OP_MSG, b"")
            + frames.encode_frame(frames.OP_MSG, bytes(range(256))))
    # worst case: the socket delivers one byte at a time
    dec = frames.FrameDecoder()
    got = []
    for i in range(len(wire)):
        got.extend(dec.feed(wire[i:i + 1]))
    assert got == [(frames.OP_HELLO, b"hello-body"),
                   (frames.OP_MSG, b""),
                   (frames.OP_MSG, bytes(range(256)))]
    assert dec.buffered == 0


def test_decoder_handles_coalesced_and_split_headers():
    a = frames.encode_frame(1, b"x" * 7)
    b = frames.encode_frame(2, b"y" * 11)
    wire = a + b
    # split inside the second frame's length header
    cut = len(a) + 2
    dec = frames.FrameDecoder()
    first = dec.feed(wire[:cut])
    assert first == [(1, b"x" * 7)]
    assert dec.feed(wire[cut:]) == [(2, b"y" * 11)]


def test_oversized_frame_rejected_before_buffering():
    dec = frames.FrameDecoder(max_frame=16)
    big = frames.encode_frame(1, b"z" * 1000)
    with pytest.raises(frames.FrameError, match="over max_frame"):
        dec.feed(big[:8])      # header alone is enough to reject
    with pytest.raises(frames.FrameError):
        frames.encode_frame(1, b"z" * 1000, max_frame=16)


def test_zero_length_frame_rejected():
    dec = frames.FrameDecoder()
    with pytest.raises(frames.FrameError, match="no opcode"):
        dec.feed(b"\x00\x00\x00\x00")


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------
PROTO_MSGS = [
    ("ping",),
    ("load", 7, {"pairs": (("T4", "V100"),), "backend": "numpy",
                 "n": None, "ok": True}),
    ("exec_ok", np.linspace(0, 1, 17), 0.25),
    ("err", "ValueError: boom"),
]


@pytest.mark.parametrize("codec", sorted(frames.CODECS))
@pytest.mark.parametrize("msg", PROTO_MSGS,
                         ids=[m[0] for m in PROTO_MSGS])
def test_codec_round_trips_protocol_tuples(codec, msg):
    pack, unpack = frames.CODECS[codec]
    out = unpack(pack(msg))
    assert isinstance(out, tuple) and out[0] == msg[0]
    for a, b in zip(msg, out):
        if isinstance(a, np.ndarray):
            assert a.tobytes() == b.tobytes()
        else:
            assert a == b


@pytest.mark.parametrize("codec", sorted(frames.CODECS))
def test_float64_tensors_round_trip_bit_identical(codec):
    pack, unpack = frames.CODECS[codec]
    rng = np.random.default_rng(0)
    # adversarial float64 content: subnormals, infs, huge magnitudes,
    # negative zero — bit-identity means the BYTES survive, not the values
    arr = rng.standard_normal((5, 31))
    value = np.ascontiguousarray(arr[::-1] * 3.7)
    arr[0, :4] = [np.inf, -np.inf, 5e-324, -0.0]
    arr[1, 0] = 1e308
    payload = {"forest": {"thr": arr, "value": value},
               "lin_coef": arr[:2], "gids": np.arange(31, dtype=np.int64)}
    out = unpack(pack(payload))
    for key in ("thr", "value"):
        got = out["forest"][key]
        assert got.dtype == np.float64
        assert got.tobytes() == payload["forest"][key].tobytes()
    assert out["gids"].dtype == np.int64
    assert out["lin_coef"].shape == (2, 31)


def test_pfc1_truncated_body_raises_frame_error():
    body = frames.pack_value(("exec_ok", np.arange(64.0), 0.1))
    for cut in (1, len(body) // 2, len(body) - 1):
        with pytest.raises(frames.FrameError):
            frames.unpack_value(body[:cut])


def test_pfc1_trailing_garbage_raises():
    with pytest.raises(frames.FrameError, match="trailing"):
        frames.unpack_value(frames.pack_value(("ping",)) + b"\x00")


def test_pfc1_array_shape_byte_mismatch_raises():
    body = bytearray(frames.pack_value(np.arange(8.0)))
    # corrupt the declared byte count (last 4 bytes of the array header)
    body[-(8 * 8) - 4:-(8 * 8)] = (99).to_bytes(4, "little")
    with pytest.raises(frames.FrameError, match="does not match shape"):
        frames.unpack_value(bytes(body))


def test_json_codec_requires_string_keys():
    with pytest.raises(frames.FrameError, match="string dict keys"):
        frames.json_pack_value({1: "x"})


# ---------------------------------------------------------------------------
# handshake / negotiation
# ---------------------------------------------------------------------------
def test_negotiate_prefers_binary_then_falls_back():
    assert frames.negotiate_codec(["json", "pfc1"]) == "pfc1"
    assert frames.negotiate_codec(["json"]) == "json"
    with pytest.raises(frames.FrameError, match="no shared codec"):
        frames.negotiate_codec(["msgpack"])


def test_parse_hello_rejects_non_worker_peers():
    with pytest.raises(frames.FrameError):
        frames.parse_hello(b"HTTP/1.1 400 Bad Request")
    with pytest.raises(frames.FrameError, match="not a shard worker"):
        frames.parse_hello(b'{"magic": "nope"}')


# ---------------------------------------------------------------------------
# negotiated deflate frame compression
# ---------------------------------------------------------------------------
def test_pack_msg_compresses_large_bodies_and_round_trips():
    body = frames.pack_value({"thr": np.zeros((64, 512)),
                              "gids": np.arange(4096, dtype=np.int64)})
    assert len(body) > frames.COMPRESS_THRESHOLD
    wire = frames.pack_msg(body, compress=True)
    dec = frames.FrameDecoder()
    [(opcode, payload)] = dec.feed(wire)
    assert opcode == frames.OP_MSG_DEFLATE
    assert len(wire) < len(body)                 # actually smaller
    assert frames.open_msg(opcode, payload) == body


def test_pack_msg_float64_bit_identity_through_deflate():
    """Compression wraps the ENCODED codec body, so adversarial float64
    content (subnormals, infs, -0.0) survives bit-exactly."""
    arr = np.random.default_rng(0).standard_normal((96, 64))
    arr[0, :4] = [np.inf, -np.inf, 5e-324, -0.0]
    body = frames.pack_value({"forest": {"thr": arr}})
    [(opcode, payload)] = frames.FrameDecoder().feed(
        frames.pack_msg(body, compress=True))
    out = frames.unpack_value(frames.open_msg(opcode, payload))
    assert out["forest"]["thr"].tobytes() == arr.tobytes()


def test_pack_msg_below_threshold_or_incompressible_stays_plain():
    small = frames.pack_value(("ping",))
    [(opcode, _)] = frames.FrameDecoder().feed(
        frames.pack_msg(small, compress=True))
    assert opcode == frames.OP_MSG               # under the threshold
    incompressible = np.random.default_rng(1).bytes(
        frames.COMPRESS_THRESHOLD + 1024)
    [(opcode, payload)] = frames.FrameDecoder().feed(
        frames.pack_msg(incompressible, compress=True))
    assert opcode == frames.OP_MSG               # zlib did not win
    assert payload == incompressible
    # compress=False never emits a deflate frame regardless of size
    big = b"a" * (frames.COMPRESS_THRESHOLD + 1024)
    [(opcode, _)] = frames.FrameDecoder().feed(
        frames.pack_msg(big, compress=False))
    assert opcode == frames.OP_MSG


def test_open_msg_rejects_unnegotiated_deflate():
    wire = frames.pack_msg(b"x" * (frames.COMPRESS_THRESHOLD + 1024),
                           compress=True)
    [(opcode, payload)] = frames.FrameDecoder().feed(wire)
    assert opcode == frames.OP_MSG_DEFLATE
    with pytest.raises(frames.FrameError, match="without negotiating"):
        frames.open_msg(opcode, payload, compressed_ok=False)


def test_open_msg_bomb_guard_caps_inflation():
    """A tiny deflate body that inflates past max_frame is rejected
    without materializing the bomb."""
    import zlib
    bomb = zlib.compress(b"\x00" * (1 << 22), 9)   # 4 MiB -> ~4 KiB
    with pytest.raises(frames.FrameError, match="inflates past"):
        frames.open_msg(frames.OP_MSG_DEFLATE, bomb, max_frame=1 << 16)
    with pytest.raises(frames.FrameError, match="bad deflate"):
        frames.open_msg(frames.OP_MSG_DEFLATE, b"not-deflate-bytes")


def test_negotiate_compress_intersects_preference():
    assert frames.negotiate_compress(["deflate"]) == "deflate"
    assert frames.negotiate_compress(["zstd", "deflate"]) == "deflate"
    assert frames.negotiate_compress(["zstd"]) is None
    assert frames.negotiate_compress([]) is None


def test_hello_bodies_carry_auth_and_compress_fields():
    hello = frames.parse_hello(frames.hello_body(
        2, ("pfc1", "json"), auth=True, compress=("deflate",)))
    assert hello["auth"] is True
    assert list(hello["compress"]) == ["deflate"]
    # absent when unarmed: old peers never see unknown-looking fields
    plain = frames.parse_hello(frames.hello_body(2, ("pfc1",)))
    assert "auth" not in plain and "compress" not in plain
    ack = frames.parse_hello(frames.hello_ack_body(
        2, "pfc1", token="tok", compress="deflate"))
    assert ack["token"] == "tok" and ack["compress"] == "deflate"
    plain_ack = frames.parse_hello(frames.hello_ack_body(2, "pfc1"))
    assert "token" not in plain_ack and "compress" not in plain_ack


def test_compressed_tcp_worker_end_to_end_bit_identical(tiny_bank):
    """Full wire path with negotiated deflate: the bank payload ships
    compressed (it is far over the threshold) and every exec answers
    bit-identically to the local bank."""
    bank, X, gids = tiny_bank
    ref = bank.execute(X, gids)
    with WorkerServer(device="cpu") as server:
        with ShardPlane(workers=0, mode="thread",
                        remote=[server.address]) as plane:
            assert plane.workers[0].compress == "deflate"
            sharded = plane.load(bank)
            assert sharded.execute(X, gids).tobytes() == ref.tobytes()
    # a server that offers no compression negotiates down to plain frames
    with WorkerServer(device="cpu", compress=()) as server:
        with ShardPlane(workers=0, mode="thread",
                        remote=[server.address]) as plane:
            assert plane.workers[0].compress is None
            sharded = plane.load(bank)
            assert sharded.execute(X, gids).tobytes() == ref.tobytes()


def test_old_protocol1_json_worker_negotiates_down(tiny_bank):
    """A protocol-1 worker that only speaks the json codec still serves
    shards for a protocol-2 parent — bit-identically, because the json
    codec also ships raw array bytes."""
    bank, X, gids = tiny_bank
    ref = bank.execute(X, gids)
    with WorkerServer(device="cpu", protocol=1, codecs=("json",)) as server:
        with ShardPlane(workers=0, mode="thread",
                        remote=[server.address]) as plane:
            w = plane.workers[0]
            assert w.protocol == 1
            assert w.codec == "json"
            sharded = plane.load(bank)
            assert sharded.execute(X, gids).tobytes() == ref.tobytes()


@pytest.fixture(scope="module")
def tiny_bank():
    """The port's bank of a small reference oracle carried over, a wave,
    and the reference bank's answer to it."""
    from repro import api
    from repro.core import workloads
    from repro.core.predictor import ProfetConfig

    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet"))
    cfg = ProfetConfig(members=("linear", "forest"), n_trees=8, seed=0)
    ref_oracle = api.LatencyOracle.fit(ds, cfg)
    oracle = carry_oracle(ref_oracle)
    bank = oracle.bank
    rng = np.random.default_rng(2)
    gids = rng.integers(0, len(bank.pairs), 24).astype(np.int64)
    cases = oracle.dataset.cases
    X = np.stack([oracle.feature_matrix(
        bank.pairs[g][0], [cases[rng.integers(len(cases))]])[0]
        for g in gids])
    np.testing.assert_array_equal(bank.execute(X, gids),
                                  ref_oracle.bank.execute(X, gids))
    return bank, X, gids


# ---------------------------------------------------------------------------
# the reference's bytes
# ---------------------------------------------------------------------------
WIRE_VALUES = PROTO_MSGS + [
    {"forest": {"thr": np.linspace(-1, 1, 12).reshape(3, 4),
                "feat": np.arange(12, dtype=np.int32).reshape(3, 4)},
     "depth": np.array([3, 0, 7], np.int64), "n": None, "f": 2.5,
     "pairs": [["T4", "V100"], ("K80", "T4")], "b": b"\x00\xff"},
    ("exec", 3, np.zeros((0, 5)), np.arange(0, dtype=np.int64)),
]


@pytest.mark.parametrize("codec", sorted(frames.CODECS))
@pytest.mark.parametrize("value", WIRE_VALUES,
                         ids=[f"v{i}" for i in range(len(WIRE_VALUES))])
def test_codec_bytes_equal_the_reference(codec, value):
    assert sorted(frames.CODECS) == sorted(ref_frames.CODECS)
    pack, unpack = frames.CODECS[codec]
    ref_pack, ref_unpack = ref_frames.CODECS[codec]
    body = pack(value)
    assert body == ref_pack(value)
    assert pack(ref_unpack(body)) == body == ref_pack(unpack(body))


def test_frames_hello_and_compression_bytes_equal_the_reference():
    for op, body in ((frames.OP_HELLO, b"hello"), (frames.OP_MSG, b""),
                     (frames.OP_MSG, bytes(range(256)) * 3)):
        assert frames.encode_frame(op, body) == \
            ref_frames.encode_frame(op, body)
    big = frames.pack_value(("load", 1, {"thr": np.zeros(4096)}))
    for compress in (False, True):
        assert frames.pack_msg(big, compress=compress) == \
            ref_frames.pack_msg(big, compress=compress)
    assert frames.hello_body(2, frames.CODEC_PREFERENCE, auth=True,
                             compress=("deflate",)) == \
        ref_frames.hello_body(2, ref_frames.CODEC_PREFERENCE, auth=True,
                              compress=("deflate",))
    assert frames.hello_ack_body(2, "pfc1", token="t",
                                 compress="deflate") == \
        ref_frames.hello_ack_body(2, "pfc1", token="t", compress="deflate")
    for name in ("MAGIC", "PROTOCOL_VERSION", "MAX_FRAME", "OP_HELLO",
                 "OP_MSG", "OP_MSG_DEFLATE", "COMPRESS_THRESHOLD",
                 "CODEC_PREFERENCE", "COMPRESS_PREFERENCE"):
        assert getattr(frames, name) == getattr(ref_frames, name), name


def test_reference_plane_serves_through_a_port_worker():
    """The wire is shared: the reference's plane ships its own bank
    payload to the port's ``WorkerServer``, which places it on its device
    and answers bit-identically to the reference bank."""
    from repro import api
    from repro.core import workloads
    from repro.core.predictor import ProfetConfig
    from repro.serve.shard import ShardPlane as RefShardPlane
    oracle = api.LatencyOracle.fit(
        workloads.generate(devices=("T4", "V100"), models=("LeNet5",)),
        ProfetConfig(members=("linear", "forest"), n_trees=4, seed=1))
    bank = oracle.bank
    X = np.stack([oracle.feature_matrix(a, oracle.dataset.cases[:3])
                  for a, _ in bank.pairs]).reshape(-1, bank.n_features)
    gids = np.repeat(np.arange(len(bank.pairs)), 3).astype(np.int64)
    want = bank.execute(X, gids)
    with WorkerServer(device="cpu") as server:
        with RefShardPlane(workers=0, mode="thread",
                           remote=[server.address]) as plane:
            got = plane.load(bank).execute(X, gids)
            assert server.loads == 1 and server.execs == 1
    assert got.tobytes() == want.tobytes()

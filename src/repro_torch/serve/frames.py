"""``repro_torch.serve.frames`` — length-prefixed binary framing + codecs for
the shard worker wire protocol.

Two layers, both dependency-free and deterministic:

**Framing.** Every message on a worker socket is one frame::

    u32  length      (little-endian; bytes that follow, opcode included)
    u8   opcode      (OP_HELLO handshake / OP_MSG protocol message)
    ...  body        (length - 1 bytes)

:class:`FrameDecoder` is the incremental parser — feed it whatever the
socket produced (half a header, three frames and a tail, one byte at a
time) and it yields exactly the complete frames, rejecting any frame
whose declared length exceeds ``max_frame`` *before* buffering its body
(a lying peer cannot balloon memory). :class:`SocketFramer` wraps a
connected socket with blocking ``send``/``recv`` built on the same
decoder, so partial reads across frame boundaries are handled in one
place.

**Codecs.** Frame bodies carry the shard pipe-protocol tuples
(``load``/``exec``/``drop``/``ping`` and their replies). Two codecs
encode them:

- ``pfc1`` — the binary tagged codec (the default). Tensor payloads use
  the same length-prefixed little-endian layout as the PFC1 columnar
  ``/measure`` body (``repro_torch.serve.transport`` builds its string columns
  and bounds-checked cursor from this module): a dtype string, a shape,
  and the raw C-contiguous bytes, decoded with one ``np.frombuffer`` —
  so a shard's stacked float64 tensors round-trip **bit-identically**
  and attach zero-copy as read-only received buffers on the worker.
- ``json`` — the protocol-1 fallback (older workers). Arrays still ride
  raw bytes (base64), so float64 payloads remain bit-exact; tuples are
  tagged so the pipe tuples survive the JSON round trip.

**Handshake.** On accept the worker sends an ``OP_HELLO`` frame whose
body is plain JSON (readable by every protocol version):
``{"magic": "PFW1", "protocol": N, "codecs": [...]}`` — the parent picks
the first codec in its own preference list the worker offers, answers
with ``{"magic", "protocol": min(ours, theirs), "codec": choice}``, and
both sides speak that codec for every subsequent ``OP_MSG`` frame. A
protocol-1 worker that only offers ``json`` therefore keeps working
against a protocol-2 parent (test-enforced in ``tests/test_frames.py``).

Two optional HELLO extensions (both additive — absent fields negotiate
to "off", so old peers keep working):

- **Auth.** A worker configured with a pre-shared token advertises
  ``"auth": true``; the parent's ack must then carry ``"token": ...``,
  which the worker compares constant-time (``hmac.compare_digest``)
  before any other frame is processed — a wrong or missing token closes
  the connection before a single ``load`` can burn CPU. A parent holding
  a token symmetrically refuses a worker that does not advertise auth.
- **Compression.** The worker offers ``"compress": ["deflate"]``; the
  parent picks one in its ack (``"compress": "deflate"``). Once
  negotiated, either side may send :data:`OP_MSG_DEFLATE` frames whose
  body is the zlib-deflated codec payload (:func:`pack_msg` only
  bothers above :data:`COMPRESS_THRESHOLD` and keeps the smaller
  encoding). Decompression is bomb-guarded: the inflated size may not
  exceed ``max_frame``. Compression wraps the *encoded* codec body, so
  float64 tensors still round-trip bit-identically. The shard wire only
  deflates the bulk ``load`` frames (one generation ship per swap) —
  per-wave ``exec`` tensors are near-incompressible float64 and paying
  zlib for them on the critical path sinks the multihost scaling floor.
"""
from __future__ import annotations

import base64
import json
import socket
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Connection magic carried in the HELLO body.
MAGIC = "PFW1"
#: Highest protocol version this build speaks.
PROTOCOL_VERSION = 2
#: Codec preference order (first shared entry wins the negotiation).
CODEC_PREFERENCE = ("pfc1", "json")
#: Frame-compression preference order (empty overlap = no compression).
COMPRESS_PREFERENCE = ("deflate",)

OP_HELLO = 1
OP_MSG = 2
#: An OP_MSG whose body is zlib-deflated; only valid after both sides
#: negotiated ``"deflate"`` in the HELLO exchange.
OP_MSG_DEFLATE = 3

#: Default per-frame size ceiling. A generation load ships a whole bank
#: shard in one frame, so the default is generous; tests shrink it to
#: exercise the rejection path.
MAX_FRAME = 1 << 30

#: Bodies at or under this many bytes are never compressed — the zlib
#: round-trip costs more than the wire saves on small control replies.
COMPRESS_THRESHOLD = 1 << 14

_LEN = struct.Struct("<I")

# PFC1 column primitives (shared with the columnar /measure body in
# repro_torch.serve.transport).
PFC_MAGIC = b"PFC1"
PFC_NULL_LEN = 0xFFFFFFFF


class FrameError(RuntimeError):
    """Unparseable, truncated, oversized, or protocol-violating bytes on
    a worker connection. Framing cannot resync past it — the caller
    treats the connection as dead."""


# ----------------------------------------------------------------------
# bounds-checked cursor (PFC1 + pfc1 codec share it)
# ----------------------------------------------------------------------
class Reader:
    """Cursor over a binary body; every read is bounds-checked so a
    truncated or lying body raises ``error`` (default
    :class:`FrameError`), never an IndexError deep inside numpy.
    Subclasses override ``error`` to surface their own typed exception
    (the HTTP transport raises ``MalformedRequestError``)."""

    error = FrameError

    def __init__(self, body: bytes):
        self.body = body
        self.off = 0

    def take(self, nbytes: int) -> memoryview:
        end = self.off + nbytes
        if end > len(self.body):
            raise self.error(
                f"truncated columnar body: needed {end} bytes, "
                f"have {len(self.body)}")
        view = memoryview(self.body)[self.off:end]
        self.off = end
        return view

    def array(self, dtype: str, n: int) -> np.ndarray:
        dt = np.dtype(dtype)
        return np.frombuffer(self.take(dt.itemsize * n), dt)

    def strings(self, n: int) -> List[Optional[str]]:
        lens = self.array("<u4", n)
        total = int(lens[lens != PFC_NULL_LEN].sum()) if n else 0
        blob = self.take(total)
        out: List[Optional[str]] = []
        pos = 0
        try:
            for ln in lens:
                if ln == PFC_NULL_LEN:
                    out.append(None)
                    continue
                out.append(bytes(blob[pos:pos + ln]).decode("utf-8"))
                pos += ln
        except UnicodeDecodeError as e:
            raise self.error(
                f"bad utf-8 in columnar string column: {e}") from e
        return out


def pack_str_column(col: Sequence[Optional[str]]) -> bytes:
    """PFC1 string column: ``u32 lens[n]`` + concatenated utf-8 bytes
    (length ``PFC_NULL_LEN`` encodes null)."""
    lens = np.empty(len(col), np.uint32)
    chunks = []
    for i, s in enumerate(col):
        if s is None:
            lens[i] = PFC_NULL_LEN
        else:
            b = str(s).encode("utf-8")
            lens[i] = len(b)
            chunks.append(b)
    return lens.tobytes() + b"".join(chunks)


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------
def encode_frame(opcode: int, body: bytes,
                 max_frame: int = MAX_FRAME) -> bytes:
    """One wire frame. Encoding enforces the same ceiling decoding does,
    so an oversized payload fails loudly at the sender instead of being
    dropped by the peer."""
    n = 1 + len(body)
    if n > max_frame:
        raise FrameError(
            f"frame of {n} bytes exceeds max_frame={max_frame}")
    return _LEN.pack(n) + bytes([opcode]) + body


def pack_msg(body: bytes, *, compress: bool = False,
             threshold: int = COMPRESS_THRESHOLD,
             max_frame: int = MAX_FRAME) -> bytes:
    """Encode one protocol message as a wire frame, deflating the body
    when compression is negotiated, the body clears ``threshold``, and
    deflate actually wins (an incompressible body stays OP_MSG — the
    receiver never inflates bytes that grew on the way in)."""
    if compress and len(body) > threshold:
        z = zlib.compress(body, 6)
        if len(z) < len(body):
            return encode_frame(OP_MSG_DEFLATE, z, max_frame)
    return encode_frame(OP_MSG, body, max_frame)


def open_msg(opcode: int, body: bytes, *, compressed_ok: bool = True,
             max_frame: int = MAX_FRAME) -> bytes:
    """Return the plain codec body of a received protocol message frame.
    Inflation is bomb-guarded: a deflated body may not expand past
    ``max_frame`` (the same ceiling the framing enforces), so a lying
    peer cannot balloon memory through the compression side door."""
    if opcode == OP_MSG:
        return body
    if opcode != OP_MSG_DEFLATE:
        raise FrameError(f"unexpected opcode {opcode} mid-stream")
    if not compressed_ok:
        raise FrameError(
            "peer sent a deflate frame without negotiating compression")
    d = zlib.decompressobj()
    try:
        out = d.decompress(body, max_frame)
    except zlib.error as e:
        raise FrameError(f"bad deflate body: {e}") from e
    if d.unconsumed_tail:
        raise FrameError(
            f"deflated body inflates past max_frame={max_frame}; "
            "rejecting")
    return out


class FrameDecoder:
    """Incremental frame parser: ``feed`` arbitrary byte chunks, get back
    every frame they complete. Handles partial reads across frame
    boundaries (a header split across two recvs, three frames coalesced
    into one) and rejects an oversized declared length before its body
    is ever buffered."""

    def __init__(self, max_frame: int = MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        frames: List[Tuple[int, bytes]] = []
        while True:
            if len(self._buf) < _LEN.size:
                return frames
            (n,) = _LEN.unpack_from(self._buf)
            if n < 1:
                raise FrameError(f"bad frame length {n} (no opcode)")
            if n > self.max_frame:
                raise FrameError(
                    f"peer declared a {n}-byte frame, over "
                    f"max_frame={self.max_frame}; rejecting")
            if len(self._buf) < _LEN.size + n:
                return frames
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            frames.append((payload[0], payload[1:]))

    @property
    def buffered(self) -> int:
        return len(self._buf)


class SocketFramer:
    """Blocking frame transport over a connected socket. One framer per
    connection; ``recv`` surfaces EOF-mid-frame (a peer that died or
    truncated a frame) as :class:`FrameError`."""

    def __init__(self, sock: socket.socket, max_frame: int = MAX_FRAME):
        self.sock = sock
        self._decoder = FrameDecoder(max_frame)
        self._ready: List[Tuple[int, bytes]] = []
        self.max_frame = int(max_frame)

    def send(self, opcode: int, body: bytes) -> None:
        self.sock.sendall(encode_frame(opcode, body, self.max_frame))

    def recv(self) -> Tuple[int, bytes]:
        while not self._ready:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise FrameError(
                    "connection closed mid-frame "
                    f"({self._decoder.buffered} buffered bytes)")
            self._ready.extend(self._decoder.feed(chunk))
        return self._ready.pop(0)


# ----------------------------------------------------------------------
# pfc1 tagged value codec (binary, bit-identical tensors)
# ----------------------------------------------------------------------
_T_NONE, _T_TRUE, _T_FALSE = b"N", b"T", b"F"
_T_INT, _T_FLOAT, _T_STR, _T_BYTES = b"i", b"f", b"s", b"b"
_T_TUPLE, _T_LIST, _T_DICT, _T_ARRAY = b"t", b"l", b"d", b"a"


def pack_value(obj: Any) -> bytes:
    """Encode a pipe-protocol value (None/bool/int/float/str/bytes,
    tuples/lists/dicts of them, numpy arrays) as tagged binary. Arrays
    are written as dtype string + shape + raw C-order bytes — float64
    tensors round-trip bit-for-bit."""
    out: List[bytes] = []
    _pack_into(obj, out)
    return b"".join(out)


def _pack_into(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(_T_TRUE if obj else _T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        out.append(_T_INT + struct.pack("<q", int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_FLOAT + struct.pack("<d", float(obj)))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_T_STR + _LEN.pack(len(b)) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_T_BYTES + _LEN.pack(len(b)) + b)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")
        out.append(_T_ARRAY + bytes([len(dt)]) + dt
                   + bytes([arr.ndim])
                   + struct.pack(f"<{arr.ndim}q", *arr.shape)
                   + _LEN.pack(0))  # placeholder replaced below
        # raw bytes are length-prefixed like a PFC1 column so the reader
        # can bounds-check before touching numpy
        out[-1] = out[-1][:-_LEN.size] + _LEN.pack(arr.nbytes)
        out.append(arr.tobytes())
    elif isinstance(obj, tuple):
        out.append(_T_TUPLE + _LEN.pack(len(obj)))
        for v in obj:
            _pack_into(v, out)
    elif isinstance(obj, list):
        out.append(_T_LIST + _LEN.pack(len(obj)))
        for v in obj:
            _pack_into(v, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT + _LEN.pack(len(obj)))
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise FrameError(
            f"cannot encode {type(obj).__name__} on the worker wire")


def unpack_value(body: bytes) -> Any:
    r = Reader(body)
    obj = _unpack_from(r)
    if r.off != len(body):
        raise FrameError(
            f"trailing bytes after value ({len(body) - r.off})")
    return obj


def _unpack_from(r: Reader) -> Any:
    tag = bytes(r.take(1))
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return struct.unpack("<q", r.take(8))[0]
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        (n,) = _LEN.unpack(r.take(4))
        try:
            return bytes(r.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise FrameError(f"bad utf-8 string: {e}") from e
    if tag == _T_BYTES:
        (n,) = _LEN.unpack(r.take(4))
        return bytes(r.take(n))
    if tag == _T_ARRAY:
        dt_len = bytes(r.take(1))[0]
        try:
            dtype = np.dtype(bytes(r.take(dt_len)).decode("ascii"))
        except (UnicodeDecodeError, TypeError) as e:
            raise FrameError(f"bad array dtype: {e}") from e
        ndim = bytes(r.take(1))[0]
        shape = struct.unpack(f"<{ndim}q",
                              r.take(8 * ndim)) if ndim else ()
        (nbytes,) = _LEN.unpack(r.take(4))
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if ndim else dtype.itemsize
        if nbytes != want:
            raise FrameError(
                f"array byte count {nbytes} does not match shape "
                f"{shape} of {dtype}")
        # zero-copy received-buffer attach: the array views the frame
        # body directly (read-only, exactly like a shared-memory attach)
        return np.frombuffer(r.take(nbytes), dtype).reshape(shape)
    if tag == _T_TUPLE:
        (n,) = _LEN.unpack(r.take(4))
        return tuple(_unpack_from(r) for _ in range(n))
    if tag == _T_LIST:
        (n,) = _LEN.unpack(r.take(4))
        return [_unpack_from(r) for _ in range(n)]
    if tag == _T_DICT:
        (n,) = _LEN.unpack(r.take(4))
        return {_unpack_from(r): _unpack_from(r) for _ in range(n)}
    raise FrameError(f"unknown value tag {tag!r}")


# ----------------------------------------------------------------------
# json fallback codec (protocol 1)
# ----------------------------------------------------------------------
def _to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {"__nd__": arr.dtype.str, "shape": list(arr.shape),
                "b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return {"__bytes__":
                base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, tuple):
        return {"__t__": [_to_jsonable(v) for v in obj]}
    if isinstance(obj, list):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        bad = [k for k in obj if not isinstance(k, str)]
        if bad:
            raise FrameError(
                f"json codec requires string dict keys, got {bad[:3]}")
        return {k: _to_jsonable(v) for k, v in obj.items()}
    raise FrameError(
        f"cannot encode {type(obj).__name__} on the worker wire")


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        if "__nd__" in obj:
            raw = base64.b64decode(obj["b64"])
            return np.frombuffer(raw, np.dtype(obj["__nd__"])) \
                .reshape(tuple(obj["shape"]))
        if "__bytes__" in obj:
            return base64.b64decode(obj["__bytes__"])
        if "__t__" in obj:
            return tuple(_from_jsonable(v) for v in obj["__t__"])
        return {k: _from_jsonable(v) for k, v in obj.items()}
    return obj


def json_pack_value(obj: Any) -> bytes:
    return json.dumps(_to_jsonable(obj)).encode("utf-8")


def json_unpack_value(body: bytes) -> Any:
    try:
        return _from_jsonable(json.loads(body.decode("utf-8")))
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
            ValueError, TypeError) as e:
        raise FrameError(f"bad json frame body: {e!r}") from e


#: codec name -> (pack, unpack)
CODECS: Dict[str, Tuple[Callable[[Any], bytes],
                        Callable[[bytes], Any]]] = {
    "pfc1": (pack_value, unpack_value),
    "json": (json_pack_value, json_unpack_value),
}


# ----------------------------------------------------------------------
# handshake
# ----------------------------------------------------------------------
def hello_body(protocol: int, codecs: Sequence[str], *,
               auth: bool = False,
               compress: Sequence[str] = ()) -> bytes:
    """The worker's HELLO: always plain JSON so any protocol version can
    read it before a codec is negotiated. ``auth`` advertises that the
    worker holds a pre-shared token (the token itself never rides the
    worker's HELLO — it is sent to *any* connecting peer); ``compress``
    lists the frame compressions the worker accepts."""
    d: Dict[str, Any] = {"magic": MAGIC, "protocol": int(protocol),
                         "codecs": list(codecs)}
    if auth:
        d["auth"] = True
    if compress:
        d["compress"] = list(compress)
    return json.dumps(d).encode("utf-8")


def hello_ack_body(protocol: int, codec: str, *,
                   token: Optional[str] = None,
                   compress: Optional[str] = None) -> bytes:
    d: Dict[str, Any] = {"magic": MAGIC, "protocol": int(protocol),
                         "codec": codec}
    if token is not None:
        d["token"] = str(token)
    if compress is not None:
        d["compress"] = str(compress)
    return json.dumps(d).encode("utf-8")


def parse_hello(body: bytes) -> Dict[str, Any]:
    try:
        d = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"bad HELLO body: {e!r}") from e
    if not isinstance(d, dict) or d.get("magic") != MAGIC:
        raise FrameError(
            f"peer is not a shard worker (magic {d.get('magic') if isinstance(d, dict) else d!r})")
    return d


def negotiate_codec(offered: Sequence[str],
                    preference: Sequence[str] = CODEC_PREFERENCE) -> str:
    """First codec in OUR preference order the peer offers; a peer with
    no shared codec is unusable."""
    offered = set(offered)
    for name in preference:
        if name in offered:
            return name
    raise FrameError(
        f"no shared codec with peer (they offer {sorted(offered)}, "
        f"we speak {list(preference)})")


def negotiate_compress(offered: Sequence[str],
                       preference: Sequence[str] = COMPRESS_PREFERENCE
                       ) -> Optional[str]:
    """First compression in OUR preference order the peer offers, or
    ``None`` — unlike codecs, no overlap just means uncompressed frames
    (every peer speaks those)."""
    offered = set(offered)
    for name in preference:
        if name in offered:
            return name
    return None

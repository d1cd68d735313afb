"""``repro_torch.serve.shard`` — multi-worker sharded wave execution.

The ``ModelBank`` stacked tensors are read-only after warm-up —
exactly the shape that shards with zero answer drift. This module turns
one bank into a **shard plane**: N workers, each holding one group-axis
slice of the bank (``ModelBank.split`` over ``planner.partition_pairs``),
so a wave's rows scatter by (anchor, target) group to their shard, every
shard answers its slice with ONE grouped launch, and the parent gathers
the predictions back into wave row order.

Three worker kinds share one protocol:

  - ``mode="spawn"`` — real processes (``multiprocessing`` spawn context:
    a forked child of a process that holds a CUDA context cannot use the
    card). Each worker is a new process with its own CUDA context and its
    own loaded kernel library. The big stacked arrays (forest node tensors
    + linear coefficients) are copied off the device once per generation
    into ``multiprocessing.shared_memory`` segments, and every worker maps
    them and places them on the bank's device — a load ships names and
    shapes, not gigabytes. On the card that placement is one host-to-device
    copy per worker (shared memory holds host arrays, not device memory);
    on the CPU the forest stack stays a view of the segment. The parent
    builds the forest kernel library before it ships a card generation, so
    no worker runs ``nvcc``; a card worker warms its bank up on load.
  - ``mode="thread"`` — in-process workers sharing sub-banks by
    reference (on the card, in the parent's CUDA context). Deterministic
    and cheap: the test suite drives shuffled completion orders, mid-wave
    deaths, and swap races through its ``delay_s`` / ``fail_loads`` /
    ``kill`` hooks.
  - ``remote=("host:port", ...)`` — workers on *other hosts*, appended
    after the local ones. Each is a :class:`WorkerServer` (usually the
    ``repro_torch.launch.shard_worker`` CLI) speaking the same
    ``load``/``exec``/``drop``/``ping`` tuples over length-prefixed
    binary frames (``repro_torch.serve.frames``): a generation load ships the
    shard's ``ModelBank.to_payload()`` — stacked float64 tensors as raw
    little-endian bytes — exactly once, and the worker attaches them as
    read-only received-buffer views (the cross-host analogue of the
    shared-memory attach; bit-identical, because the bytes are the
    bytes). Socket faults (reset, truncated frame, slow peer — see the
    ``shard.worker.*`` sites in ``repro_torch.serve.faults``) surface as
    :class:`WorkerDeadError` on the parent and degrade exactly like a
    local worker death: riding rows fail typed, the breaker force-opens,
    later waves route parent-side.

Every worker kind also answers a ``stats`` op (a port extension of the
protocol): its pid, the forest kernel launches counted in its process,
and on the card the device memory it holds — how a caller shows that a
worker process ran the kernel on the card.

Each worker's pipe is owned by a single dispatcher thread (submissions
return ``concurrent.futures.Future``), so the wave pump and a concurrent
``oracle_refreshed`` swap can both talk to the plane without interleaving
messages on one pipe — and slices submitted to different workers overlap.

**Generations.** Every loaded bank gets a generation id. ``load`` is
all-or-nothing: if any live worker fails to load, everything already
loaded is dropped, the shared segments are unlinked, and the caller's
swap aborts with the incumbent intact. A wave acquires its generation at
admission and releases it after gather; ``retire`` defers the actual
drop until in-flight waves drain, and a retired generation that somehow
still executes answers parent-side through the full bank — so no wave
can ever mix epochs across shards.

**Degradation.** A worker that dies mid-wave fails only its slice: the
wave raises :class:`repro_torch.api.types.PartialExecutionError` carrying the
surviving predictions plus the failed-row mask, the executor turns that
into per-request :class:`ShardExecutionError` (HTTP 500) for exactly the
riding requests, and the breaker force-opens the shard so subsequent
waves route its rows parent-side through the full bank (the degraded
single-worker fallback — bit-identical, just not parallel). Transient
slice failures go through the normal closed/open/half-open breaker.
"""
from __future__ import annotations

import atexit
import hmac
import os
import queue
import secrets
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.bank import ModelBank, device_tensor, host_array
from repro_torch.api.planner import partition_pairs
from repro_torch.api.types import PartialExecutionError
from repro_torch.kernels import forest_eval
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import frames
from repro_torch.serve.resilience import CircuitBreaker

_SHM_ARRAYS = ("feat", "thr", "left", "right", "value")


class WorkerDeadError(RuntimeError):
    """The shard worker's process (or thread persona) is gone — pipe
    broke, process killed, or an injected test death. Never probed again:
    the plane force-opens the shard's breaker key (until the lifecycle
    supervisor adopts a replacement, which heals exactly that key)."""


class WorkerAuthError(RuntimeError):
    """The PFW1 handshake could not be authenticated: the worker
    requires a pre-shared token the parent does not hold, the parent
    holds one the worker does not enforce, or the worker rejected the
    token we sent. Raised at connection time — an unauthenticated peer
    is never adopted into the plane."""


# ----------------------------------------------------------------------
# bank <-> worker spec (spawn mode)
# ----------------------------------------------------------------------
def segment_prefix(pid: Optional[int] = None) -> str:
    """The name prefix of the shared-memory segments process ``pid``
    (default: this one) publishes bank shards in."""
    return f"repro_torch_{os.getpid() if pid is None else pid}_"


def _bank_to_spec(bank: ModelBank) -> Tuple[dict, list]:
    """Publish ``bank``'s big stacked arrays as shared-memory segments
    and return ``(spec, segments)``: a small picklable spec (names +
    shapes + the genuinely small tensors) and the parent-held segments
    (the parent owns their lifetime — unlinked at generation retire).
    Each segment is named :func:`segment_prefix` + random hex, so the
    segments of one process can be told from those of any other."""
    from multiprocessing import shared_memory
    segments: list = []
    arrays: Dict[str, Tuple[str, tuple, str]] = {}

    def share(name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        seg = shared_memory.SharedMemory(
            create=True, size=max(arr.nbytes, 1),
            name=segment_prefix() + secrets.token_hex(8))
        np.ndarray(arr.shape, arr.dtype, buffer=seg.buf)[...] = arr
        segments.append(seg)
        arrays[name] = (seg.name, arr.shape, arr.dtype.str)

    try:
        if bank.forest is not None:
            for k in _SHM_ARRAYS:
                share("forest." + k, host_array(bank.forest[k]))
        if bank.lin_coef is not None:
            share("lin_coef", bank.lin_coef)
    except Exception:
        _release_segments(segments, unlink=True)
        raise
    spec = {
        "pairs": bank.pairs,
        "members": bank.members,
        "n_features": bank.n_features,
        "devices": bank.devices,
        "scalers": bank.scalers,
        "device": str(bank.device),
        "depth": (None if bank.forest is None
                  else host_array(bank.forest["depth"])),
        "dnn": (None if bank.dnn is None
                else ([{k: host_array(v) for k, v in layer.items()}
                       for layer in bank.dnn[0]], bank.dnn[1], bank.dnn[2],
                      bank.dnn[3])),
        "arrays": arrays,
    }
    return spec, segments


def _bank_from_spec(spec: dict) -> Tuple[ModelBank, list]:
    """Worker side: attach the shared segments and rebuild a ``ModelBank``
    on the spec's device: the forest stack is placed there (a zero-copy
    view of the segments on the CPU, a host-to-device copy on the card),
    the linear coefficients stay views of their segment. Returns the bank
    plus the attached segments (closed when the generation is dropped)."""
    from multiprocessing import shared_memory
    segments: list = []

    def attach(name: str, shape: tuple, dtype: str) -> np.ndarray:
        # NOTE: Python 3.10 registers attached segments with the resource
        # tracker too, but spawn workers share the parent's tracker (its
        # fd rides the preparation data) and registration is a set — the
        # parent's unlink at generation retire removes the single entry,
        # so no manual unregister gymnastics are needed here.
        seg = shared_memory.SharedMemory(name=name)
        segments.append(seg)
        return np.ndarray(shape, np.dtype(dtype), buffer=seg.buf)

    dev = resolve_device(spec["device"])
    arrays = {k: attach(*v) for k, v in spec["arrays"].items()}
    forest = None
    if spec["depth"] is not None:
        forest = {k: device_tensor(arrays["forest." + k], dev)
                  for k in _SHM_ARRAYS}
        forest["depth"] = device_tensor(spec["depth"], dev)
    dnn = None
    if spec["dnn"] is not None:
        params, mu, sd, ys = spec["dnn"]
        dnn = ([{k: device_tensor(v, dev) for k, v in layer.items()}
                for layer in params], mu, sd, ys)
    bank = ModelBank(pairs=spec["pairs"], members=spec["members"],
                     n_features=spec["n_features"], forest=forest,
                     lin_coef=arrays.get("lin_coef"), dnn=dnn,
                     devices=spec["devices"], scalers=spec["scalers"],
                     device=dev)
    if dev.type == "cuda":
        # the first wave served by this worker pays no one-off cost
        bank.warmup()
    return bank, segments


def _worker_stats(device=None) -> dict:
    """What a worker reports for the ``stats`` op: its pid, the kernel
    launches counted in its process and, on the card, the device memory
    it holds."""
    out = {"pid": os.getpid(), "launches": dict(forest_eval.launches)}
    if device is not None and torch.device(device).type == "cuda":
        out["cuda_memory_allocated"] = int(
            torch.cuda.memory_allocated(device))
    return out


def _build_kernels(device) -> None:
    """Build the forest kernel library in this (parent) process before a
    worker process on the card needs it, so no worker runs ``nvcc``; a
    no-op off the card or when the hashed library exists."""
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(["forest_eval"])


def _release_segments(segments, unlink: bool) -> None:
    for seg in segments:
        try:
            seg.close()
            if unlink:
                seg.unlink()
        except Exception:
            pass


def _spawn_worker_main(conn) -> None:
    """Spawn-worker child loop (module level: spawn pickles the target).
    One request, one reply, strictly in order — the parent's dispatcher
    thread is the only writer on the other end."""
    banks: Dict[int, Tuple[ModelBank, list]] = {}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        op = msg[0]
        try:
            if op == "load":
                _, gen_id, spec = msg
                banks[gen_id] = _bank_from_spec(spec)
                conn.send(("ok",))
            elif op == "exec":
                _, gen_id, X, gids = msg
                bank = banks[gen_id][0]
                # busy is CPU time, not wall: on an oversubscribed host a
                # descheduled worker's wall clock absorbs its neighbours'
                # runtime, which would poison any critical-path estimate
                # built from these numbers (the process is single-threaded,
                # so process_time IS this exec's own compute)
                t0 = time.process_time()
                preds = bank.execute(X, gids)
                conn.send(("exec_ok", preds, time.process_time() - t0))
            elif op == "drop":
                entry = banks.pop(msg[1], None)
                if entry is not None:
                    _release_segments(entry[1], unlink=False)
                conn.send(("ok",))
            elif op == "ping":
                conn.send(("ok",))
            elif op == "stats":
                conn.send(("stats_ok", _worker_stats(
                    next(iter(banks.values()))[0].device if banks
                    else None)))
            elif op == "exit":
                conn.send(("ok",))
                break
            else:
                conn.send(("err", f"unknown op {op!r}"))
        except Exception as e:  # report, never die on a bad request
            try:
                conn.send(("err", f"{type(e).__name__}: {e}"))
            except Exception:
                break
    try:
        conn.close()
    except Exception:
        pass


# ----------------------------------------------------------------------
# workers
# ----------------------------------------------------------------------
class _BaseWorker:
    """One shard worker behind a dispatcher thread that owns its channel.
    ``submit`` enqueues an op and returns a Future; ops on one worker are
    serialized (pipe protocol) while different workers overlap."""

    kind = "abstract"

    def __init__(self, index: int):
        self.index = index
        self.alive = True
        # set by the lifecycle supervisor on a missed lease: waves route
        # this shard's rows parent-side until a lease renews (or the
        # worker is declared dead and replaced)
        self.suspect = False
        self.death_reason: Optional[str] = None
        self.execs = 0
        self.busy_s = 0.0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._drain, daemon=True, name=f"shard-worker-{index}")
        self._thread.start()

    def submit(self, op: tuple) -> Future:
        fut: Future = Future()
        if not self.alive:
            fut.set_exception(WorkerDeadError(
                self.death_reason or f"worker {self.index} is dead"))
            return fut
        self._q.put((op, fut))
        return fut

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            op, fut = item
            if not self.alive:
                fut.set_exception(WorkerDeadError(
                    self.death_reason or f"worker {self.index} is dead"))
                continue
            try:
                fut.set_result(self._call(op))
            except WorkerDeadError as e:
                self.alive = False
                self.death_reason = str(e)
                fut.set_exception(e)
            except Exception as e:
                fut.set_exception(e)

    def _call(self, op: tuple):
        raise NotImplementedError

    def stats(self, timeout_s: float = 30.0) -> dict:
        """The worker's ``stats`` op: its pid, the kernel launches counted
        in its process (``forest_eval.launches``; a thread worker shares
        its parent's) and, on the card, the device memory it holds. A
        port extension of the protocol: a reference worker answers it
        with an error."""
        return self.submit(("stats",)).result(timeout=timeout_s)

    def prepare_load(self, gen_id: int, sub: ModelBank
                     ) -> Tuple[tuple, list]:
        """Build this worker kind's ``load`` op for one sub-bank. Returns
        ``(op, parent_segments)`` — segments are the parent-held shared
        memory (spawn mode only; empty elsewhere) whose lifetime the
        generation owns."""
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        if self.alive:
            self.submit(("exit",))
        self._q.put(None)
        self._thread.join(timeout=5.0)


class _ProcessWorker(_BaseWorker):
    """Spawn-context process worker; a broken pipe IS the death signal."""

    kind = "spawn"

    def __init__(self, index: int):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_spawn_worker_main, args=(child,),
                                 daemon=True,
                                 name=f"profet-shard-{index}")
        self._proc.start()
        child.close()
        super().__init__(index)

    def _call(self, op: tuple):
        try:
            self._conn.send(op)
            reply = self._conn.recv()
        except (EOFError, OSError) as e:
            raise WorkerDeadError(
                f"worker {self.index} channel broke "
                f"({type(e).__name__})") from e
        tag = reply[0]
        if tag == "exec_ok":
            _, preds, busy = reply
            self.execs += 1
            self.busy_s += busy
            return preds, busy
        if tag == "stats_ok":
            return reply[1]
        if tag == "ok":
            return None
        raise RuntimeError(f"worker {self.index}: {reply[1]}")

    def prepare_load(self, gen_id: int, sub: ModelBank
                     ) -> Tuple[tuple, list]:
        spec, segments = _bank_to_spec(sub)
        return ("load", gen_id, spec), segments

    def kill(self) -> None:
        """Hard-kill the process; the dispatcher's in-flight or next pipe
        op surfaces the death as :class:`WorkerDeadError`."""
        try:
            self._proc.kill()
        except Exception:
            pass

    def close(self) -> None:
        super().close()
        try:
            self._proc.join(timeout=5.0)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=5.0)
        except Exception:
            pass
        try:
            self._conn.close()
        except Exception:
            pass
        try:
            # release the Process object's sentinel fd — repeated
            # kill/respawn cycles must not accumulate pipe fds
            self._proc.close()
        except Exception:
            pass


class _ThreadWorker(_BaseWorker):
    """In-process worker persona for deterministic tests: sub-banks are
    held by reference, ``delay_s`` stretches each exec (to force
    completion orders and swap races), ``fail_loads`` injects load
    failures, ``kill`` makes queued and in-flight ops die like a broken
    pipe would."""

    kind = "thread"

    def __init__(self, index: int):
        self._banks: Dict[int, ModelBank] = {}
        self.delay_s = 0.0
        self.fail_loads = 0
        super().__init__(index)

    def _call(self, op: tuple):
        kind = op[0]
        if kind == "load":
            if self.fail_loads > 0:
                self.fail_loads -= 1
                raise RuntimeError(
                    f"injected load failure on worker {self.index}")
            self._banks[op[1]] = op[2]
            return None
        if kind == "exec":
            _, gen_id, X, gids = op
            if self.delay_s:
                time.sleep(self.delay_s)
            if not self.alive:
                raise WorkerDeadError(
                    self.death_reason or f"worker {self.index} was killed")
            # CPU time for the same reason as the spawn worker: busy must
            # not absorb time this thread spent descheduled
            t0 = time.thread_time()
            preds = self._banks[gen_id].execute(X, gids)
            busy = time.thread_time() - t0
            self.execs += 1
            self.busy_s += busy
            return preds, busy
        if kind == "drop":
            self._banks.pop(op[1], None)
            return None
        if kind == "stats":
            return _worker_stats(next(iter(self._banks.values())).device
                                 if self._banks else None)
        if kind in ("ping", "exit"):
            return None
        raise RuntimeError(f"unknown op {kind!r}")

    def prepare_load(self, gen_id: int, sub: ModelBank
                     ) -> Tuple[tuple, list]:
        return ("load", gen_id, sub), []

    def kill(self) -> None:
        self.death_reason = f"worker {self.index} was killed"
        self.alive = False


class _RemoteWorker(_BaseWorker):
    """TCP shard worker: the same ``load``/``exec``/``drop``/``ping``
    tuples as the pipe protocol, framed and codec-encoded over a socket
    (``repro_torch.serve.frames``). The connection + handshake happen at
    construction — a plane pointing at a worker that isn't there fails
    loudly at build time, not on the first wave. Any socket error, frame
    error, or timeout afterwards is the death signal: remote workers are
    never reconnected (the breaker + parent-side fallback own recovery),
    so a half-delivered wave can never be blindly replayed."""

    kind = "tcp"

    def __init__(self, index: int, host: str, port: int, *,
                 io_timeout_s: float = 60.0,
                 max_frame: int = frames.MAX_FRAME,
                 token: Optional[str] = None):
        self.host = host
        self.port = int(port)
        self.io_timeout_s = float(io_timeout_s)
        self.token = token
        self.max_frame = int(max_frame)
        sock = socket.create_connection((host, self.port),
                                        timeout=self.io_timeout_s)
        sock.settimeout(self.io_timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._framer = frames.SocketFramer(sock, max_frame)
        try:
            # the worker speaks first: HELLO with its protocol + codecs
            opcode, body = self._framer.recv()
            if opcode != frames.OP_HELLO:
                raise frames.FrameError(
                    f"expected HELLO, got opcode {opcode}")
            hello = frames.parse_hello(body)
            wants_auth = bool(hello.get("auth"))
            if wants_auth and token is None:
                raise WorkerAuthError(
                    f"worker {host}:{port} requires a pre-shared token "
                    "(--worker-token / PROFET_WORKER_TOKEN)")
            if token is not None and not wants_auth:
                # an impostor on the worker's port would happily skip the
                # check — refuse to adopt a peer that won't authenticate
                raise WorkerAuthError(
                    f"worker {host}:{port} does not enforce auth but "
                    "this plane holds a token; refusing the peer")
            self.protocol = min(frames.PROTOCOL_VERSION,
                                int(hello.get("protocol", 1)))
            self.codec = frames.negotiate_codec(
                hello.get("codecs", ("json",)))
            self.compress = frames.negotiate_compress(
                hello.get("compress", ()))
            self._framer.send(frames.OP_HELLO, frames.hello_ack_body(
                self.protocol, self.codec, token=token,
                compress=self.compress))
            self._pack, self._unpack = frames.CODECS[self.codec]
            if wants_auth:
                # round-trip a ping so a rejected token fails HERE, not
                # on the first wave: the worker closes without replying
                # when the constant-time compare fails
                reply = self._roundtrip(("ping",))
                if reply != ("ok",):
                    raise WorkerAuthError(
                        f"worker {host}:{port} rejected the handshake "
                        f"probe ({reply!r})")
        except Exception as e:
            try:
                sock.close()
            except OSError:
                pass
            if isinstance(e, (OSError, frames.FrameError)) \
                    and token is not None:
                # the worker's auth rejection is a silent close
                raise WorkerAuthError(
                    f"worker {host}:{port} closed during the "
                    f"authenticated handshake ({type(e).__name__}: {e})"
                ) from e
            raise
        super().__init__(index)

    def _roundtrip(self, op: tuple):
        """One request/reply on the framer (pre-dispatcher handshake
        use; ``_call`` is the dispatcher-thread path). Only the bulk
        ``load`` frames (one generation ship per swap) are deflated:
        per-wave ``exec`` tensors are effectively incompressible float64
        noise, and paying zlib for them on the parent's critical path
        measurably sinks the multihost scaling floor."""
        self._framer.sock.sendall(frames.pack_msg(
            self._pack(op),
            compress=self.compress is not None and op[0] == "load",
            max_frame=self.max_frame))
        opcode, body = self._framer.recv()
        return self._unpack(frames.open_msg(
            opcode, body, compressed_ok=self.compress is not None,
            max_frame=self.max_frame))

    def _call(self, op: tuple):
        try:
            reply = self._roundtrip(op)
        except (OSError, frames.FrameError) as e:
            # timeout, reset, truncated/oversized frame, undecodable body:
            # the connection state is unknowable (a late reply could pair
            # with the wrong request) -> the worker is dead to us
            raise WorkerDeadError(
                f"worker {self.index} ({self.host}:{self.port}) "
                f"connection broke ({type(e).__name__}: {e})") from e
        tag = reply[0]
        if tag == "exec_ok":
            _, preds, busy = reply
            self.execs += 1
            self.busy_s += float(busy)
            return np.asarray(preds, np.float64), float(busy)
        if tag == "stats_ok":
            return reply[1]
        if tag == "ok":
            return None
        raise RuntimeError(f"worker {self.index}: {reply[1]}")

    def prepare_load(self, gen_id: int, sub: ModelBank
                     ) -> Tuple[tuple, list]:
        # remote distribution: the whole shard — stacked float64 tensors
        # included — rides this one op's frame; no segments to own
        return ("load", gen_id, sub.to_payload()), []

    def kill(self) -> None:
        try:
            self._framer.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._framer.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        super().close()
        try:
            self._framer.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# worker-side TCP server + loopback launcher
# ----------------------------------------------------------------------
class WorkerServer:
    """The serving half of :class:`_RemoteWorker`: accept parent
    connections on ``host:port`` and run the framed pipe protocol, one
    handler thread per connection with its own generation table (a
    restarted parent can never see a predecessor's banks). In-process for
    tests and loopback benches, or behind the
    ``repro_torch.launch.shard_worker`` CLI on a real remote host.

    ``protocol``/``codecs`` are configurable so tests can stand up an
    older, json-only protocol-1 worker and prove the parent negotiates
    down. The three ``shard.worker.*`` fault sites fire on the reply path
    of every message: ``slow`` delays the reply (client timeout), ``reset``
    RST-closes instead of replying, ``frame`` sends a deliberately
    truncated frame then RST-closes.

    ``device`` is where the worker places the banks it receives
    (``ModelBank.from_payload``); asking for CUDA on a host without it
    raises here. A card worker warms each bank up on load.

    ``token`` arms the authenticated handshake: the HELLO advertises
    ``auth``, and a parent ack whose ``token`` fails the constant-time
    compare is closed before any ``load`` is processed
    (``auth_rejects`` counts them). ``compress`` lists the frame
    compressions offered in the HELLO (deflate by default)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 faults: Optional[faults_mod.FaultInjector] = None,
                 protocol: int = frames.PROTOCOL_VERSION,
                 codecs: Sequence[str] = frames.CODEC_PREFERENCE,
                 max_frame: int = frames.MAX_FRAME,
                 token: Optional[str] = None,
                 compress: Sequence[str] = frames.COMPRESS_PREFERENCE,
                 device="cuda"):
        self.device = resolve_device(device)
        self._faults = faults
        self.protocol = int(protocol)
        self.codecs = tuple(codecs)
        self.max_frame = int(max_frame)
        self.token = token
        self.compress = tuple(compress)
        self.execs = 0
        self.loads = 0
        self.auth_rejects = 0
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"shard-server-{self.port}")
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return          # listener closed
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
                t = threading.Thread(target=self._handle, args=(conn,),
                                     daemon=True,
                                     name=f"shard-conn-{self.port}")
                self._threads.append(t)
            t.start()

    @staticmethod
    def _rst_close(sock: socket.socket) -> None:
        """Close with SO_LINGER 0 — the peer sees a hard RST, not an
        orderly FIN (the 'connection reset' chaos shape)."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _handle(self, conn: socket.socket) -> None:
        banks: Dict[int, ModelBank] = {}
        framer = frames.SocketFramer(conn, self.max_frame)
        try:
            framer.send(frames.OP_HELLO,
                        frames.hello_body(self.protocol, self.codecs,
                                          auth=self.token is not None,
                                          compress=self.compress))
            opcode, body = framer.recv()
            if opcode != frames.OP_HELLO:
                return
            ack = frames.parse_hello(body)
            if self.token is not None and not hmac.compare_digest(
                    self.token, str(ack.get("token", ""))):
                # wrong or missing token: close before a single further
                # frame is read — no load can ever burn CPU here
                with self._lock:
                    self.auth_rejects += 1
                return
            codec = ack.get("codec")
            if codec not in self.codecs or codec not in frames.CODECS:
                return
            compress = ack.get("compress")
            if compress is not None and compress not in self.compress:
                return              # parent picked something we never offered
            deflate = compress is not None
            pack, unpack = frames.CODECS[codec]
            while True:
                opcode, body = framer.recv()
                msg = unpack(frames.open_msg(
                    opcode, body, compressed_ok=deflate,
                    max_frame=self.max_frame))
                reply, last = self._dispatch(banks, msg)
                # chaos on the reply path (no-ops without an injector)
                faults_mod.fire(self._faults, faults_mod.SITE_SHARD_SLOW)
                try:
                    faults_mod.fire(self._faults,
                                    faults_mod.SITE_SHARD_RESET)
                except faults_mod.InjectedFault:
                    self._rst_close(conn)
                    return
                # mirror the parent's policy: only bulk-transfer replies
                # may deflate; exec_ok tensors stay raw off the hot path
                encoded = frames.pack_msg(
                    pack(reply), compress=deflate and msg[0] == "load",
                    max_frame=self.max_frame)
                if faults_mod.should_drop(self._faults,
                                          faults_mod.SITE_SHARD_FRAME):
                    conn.sendall(encoded[:max(5, len(encoded) // 2)])
                    self._rst_close(conn)
                    return
                conn.sendall(encoded)
                if last:
                    return
        except (frames.FrameError, OSError, EOFError):
            return              # peer gone / bytes unusable: drop the conn
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, banks: Dict[int, ModelBank], msg: tuple
                  ) -> Tuple[tuple, bool]:
        op = msg[0]
        try:
            if op == "load":
                _, gen_id, payload = msg
                bank = ModelBank.from_payload(payload, device=self.device)
                if self.device.type == "cuda":
                    bank.warmup()
                banks[int(gen_id)] = bank
                with self._lock:
                    self.loads += 1
                return ("ok",), False
            if op == "exec":
                _, gen_id, X, gids = msg
                bank = banks[int(gen_id)]
                # CPU time, same rationale as the pipe workers: each
                # connection is one thread, so thread_time IS this exec
                t0 = time.thread_time()
                preds = bank.execute(np.asarray(X, np.float64),
                                     np.asarray(gids, np.int64))
                busy = time.thread_time() - t0
                with self._lock:
                    self.execs += 1
                return ("exec_ok", preds, busy), False
            if op == "drop":
                banks.pop(int(msg[1]), None)
                return ("ok",), False
            if op == "ping":
                return ("ok",), False
            if op == "stats":
                return ("stats_ok", _worker_stats(self.device)), False
            if op == "exit":
                return ("ok",), True
            return ("err", f"unknown op {op!r}"), False
        except Exception as e:   # report, never die on a bad request
            return ("err", f"{type(e).__name__}: {e}"), False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
            threads = list(self._threads)
        try:
            # close() alone does not wake a blocked accept() on Linux;
            # shutdown() makes it return immediately
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "WorkerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TcpWorkerPool:
    """N loopback ``repro_torch.launch.shard_worker`` subprocesses, each
    on an ephemeral port — the multi-host topology on one machine (real
    processes, real sockets, real serialization). Context-manage it and
    hand ``addresses`` to ``ShardPlane(remote=...)``.

    ``respawn(i)`` relaunches one dead subprocess (new ephemeral port)
    and returns the new address — the lifecycle supervisor's reconnect
    hook. The pool registers an ``atexit`` reaper so an abnormal parent
    exit (uncaught exception past the context manager) never leaves
    orphan worker subprocesses behind; a normal ``close`` unregisters
    it."""

    def __init__(self, procs: List[subprocess.Popen],
                 addresses: List[str],
                 launcher: Optional[Callable[[], subprocess.Popen]] = None):
        self.procs = procs
        self.addresses = addresses
        self._launcher = launcher
        self._closed = False
        atexit.register(self.close)

    def kill(self, index: int) -> None:
        """Chaos hook: hard-kill one worker process mid-anything."""
        self.procs[index].kill()

    @staticmethod
    def _reap(p: subprocess.Popen) -> None:
        try:
            p.terminate()
        except Exception:
            pass
        try:
            p.wait(timeout=5.0)
        except Exception:
            try:
                p.kill()
                p.wait(timeout=5.0)
            except Exception:
                pass
        if p.stdout is not None:
            try:
                p.stdout.close()
            except Exception:
                pass

    def respawn(self, index: int) -> str:
        """Reap the dead subprocess at ``index``, launch a fresh one,
        and return its (new) ``host:port``."""
        if self._launcher is None:
            raise RuntimeError("pool was built without a launcher")
        self._reap(self.procs[index])
        p = self._launcher()
        addr = _read_worker_address(p)
        self.procs[index] = p
        self.addresses[index] = addr
        return addr

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        for p in self.procs:
            try:
                p.terminate()
            except Exception:
                pass
        for p in self.procs:
            self._reap(p)

    def __enter__(self) -> "TcpWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_worker_address(p: subprocess.Popen) -> str:
    line = p.stdout.readline().strip()
    if not line.startswith("listening "):
        raise RuntimeError(
            f"shard worker failed to start (got {line!r})")
    return line.split(" ", 1)[1]


def launch_tcp_workers(n: int, *, host: str = "127.0.0.1",
                       token: Optional[str] = None,
                       device="cuda") -> TcpWorkerPool:
    """Spawn ``n`` shard-worker subprocesses on loopback ephemeral ports,
    each placing its banks on ``device`` (``--device``), and wait for
    each to announce ``listening HOST:PORT`` on stdout. For the card the
    forest kernel library is built here first, so no worker runs
    ``nvcc``. ``token`` arms the authenticated handshake on every worker
    (passed via the environment, not argv — invisible to ``ps``)."""
    import repro_torch
    dev = resolve_device(device)
    _build_kernels(dev)
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if token is not None:
        env["PROFET_WORKER_TOKEN"] = token
    else:
        env.pop("PROFET_WORKER_TOKEN", None)

    def launch() -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.shard_worker",
             "--host", host, "--port", "0", "--device", str(dev)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env)

    procs: List[subprocess.Popen] = []
    addresses: List[str] = []
    try:
        for _ in range(n):
            procs.append(launch())
        for p in procs:
            addresses.append(_read_worker_address(p))
    except Exception:
        TcpWorkerPool(procs, addresses).close()
        raise
    return TcpWorkerPool(procs, addresses, launcher=launch)


# ----------------------------------------------------------------------
# generations + the sharded-bank facade
# ----------------------------------------------------------------------
class _GenState:
    """Refcounted lifetime of one loaded bank generation. Keeps the full
    bank + partition by reference so the lifecycle supervisor can re-ship
    a recovered worker's shard of any generation that is still live."""

    def __init__(self, gen_id: int, segments: list,
                 bank: Optional[ModelBank] = None,
                 partition: Optional[tuple] = None):
        self.gen_id = gen_id
        self.segments = segments     # parent-held shm (spawn mode)
        self.bank = bank
        self.partition = partition
        self.active = 0              # waves currently executing on it
        self.retired = False
        self.dropped = False

    def sub_bank(self, index: int) -> Optional[ModelBank]:
        """This generation's shard for worker ``index`` (None when the
        partition assigned it no pairs)."""
        if self.bank is None or self.partition is None:
            return None
        subs = self.bank.split(self.partition)
        return subs[index] if index < len(subs) else None


class ShardedBank:
    """Drop-in ``ModelBank`` facade over one loaded generation of a
    :class:`ShardPlane`: same ``execute`` / ``interpolate`` / ``supports``
    surface (``repro_torch.api.executor`` can't tell the difference), but
    ``execute`` scatters rows to their (anchor, target) shard, runs every
    shard's grouped launch concurrently, and gathers back into row order.
    Answers are bit-identical to the full bank — sharding is pure
    group-axis slicing of the same float64 tensors."""

    def __init__(self, plane: "ShardPlane", gen: _GenState,
                 full: ModelBank,
                 partition: Tuple[Tuple[Tuple[str, str], ...], ...]):
        self._plane = plane
        self._gen = gen
        self._full = full
        self.partition = partition
        self.pairs = full.pairs
        self.gid = full.gid
        self.dev_id = full.dev_id
        self.members = full.members
        self.n_features = full.n_features
        self.devices = full.devices
        # global gid -> (shard, local gid inside that shard's sub-bank)
        n = len(full.pairs)
        self._shard_of = np.empty(n, np.int64)
        self._local_gid = np.empty(n, np.int64)
        for s, part in enumerate(partition):
            for j, pair in enumerate(part):
                g = full.gid[pair]
                self._shard_of[g] = s
                self._local_gid[g] = j
        # last-wave accounting for bench_shard's critical-path metric
        self.last_wave: Optional[dict] = None

    @property
    def gen_id(self) -> int:
        return self._gen.gen_id

    def supports(self, pairs) -> bool:
        return self._full.supports(pairs)

    def interpolate(self, *args, **kwargs):
        # phase-2 is per-device and pure numpy: parent-side, bit-identical
        return self._full.interpolate(*args, **kwargs)

    def execute(self, X: np.ndarray, gids: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        gids = np.asarray(gids, np.int64)
        plane = self._plane
        if self._gen.retired:
            # a wave raced a retire without holding a ref — serve it
            # parent-side rather than touch workers that may have dropped
            return self._full.execute(X, gids)
        shard = self._shard_of[gids]
        t0 = time.perf_counter()
        pending: List[Tuple[int, np.ndarray, Future]] = []
        fallback_rows: List[np.ndarray] = []
        for s in np.unique(shard):
            rows = np.nonzero(shard == s)[0]
            w = plane.workers[s]
            if not w.alive or w.suspect \
                    or not plane.breaker.allow(("shard", int(s))):
                # dead, lease-suspect, or quarantined: the parent answers
                # this slice — no wave ever rides a worker whose lease
                # has lapsed
                fallback_rows.append(rows)
                continue
            pending.append((int(s), rows, w.submit(
                ("exec", self._gen.gen_id, X[rows],
                 self._local_gid[gids[rows]]))))
        preds = np.full(len(gids), np.nan)
        failed = np.zeros(len(gids), bool)
        busy: Dict[int, float] = {}
        reasons: List[str] = []
        for rows in fallback_rows:
            # degraded fallback: the parent answers a dead/quarantined
            # shard's slice through the full bank — bit-identical, and it
            # overlaps the live shards' in-flight futures
            preds[rows] = self._full.execute(X[rows], gids[rows])
            plane.fallback_rows += len(rows)
        for s, rows, fut in pending:
            key = ("shard", s)
            try:
                p, b = fut.result()
            except WorkerDeadError as e:
                plane.breaker.force_open(key)
                plane.slice_errors += 1
                failed[rows] = True
                reasons.append(f"shard {s}: {e}")
                continue
            except Exception as e:
                plane.breaker.record_failure(key)
                plane.slice_errors += 1
                failed[rows] = True
                reasons.append(f"shard {s}: {type(e).__name__}: {e}")
                continue
            plane.breaker.record_success(key)
            plane.slices += 1
            preds[rows] = p
            busy[s] = b
        self.last_wave = {"wall_s": time.perf_counter() - t0,
                          "busy_s": busy, "rows": len(gids),
                          "fallback": sum(len(r) for r in fallback_rows)}
        if failed.any():
            raise PartialExecutionError("; ".join(reasons), preds, failed)
        return preds


# ----------------------------------------------------------------------
# the plane
# ----------------------------------------------------------------------
def _parse_addr(addr: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    if isinstance(addr, (tuple, list)):
        return str(addr[0]), int(addr[1])
    host, _, port = str(addr).rpartition(":")
    if not host or not port:
        raise ValueError(f"remote worker address {addr!r} is not "
                         "'host:port'")
    return host, int(port)


class ShardPlane:
    """N shard workers plus generation lifecycle. One plane outlives many
    bank generations (each ``oracle_refreshed`` swap loads a new one);
    workers outlive generations, and the per-shard breaker state carries
    across swaps until ``breaker.reset()``.

    ``workers`` local workers of ``mode`` come first; each ``remote``
    address (``"host:port"`` of a :class:`WorkerServer`) appends a TCP
    worker after them, taking the next shard indices — the partition,
    scatter/gather, generations, and breaker treat every kind
    identically."""

    def __init__(self, workers: int = 2, mode: str = "spawn",
                 breaker: Optional[CircuitBreaker] = None,
                 remote: Sequence[Union[str, Tuple[str, int]]] = (),
                 io_timeout_s: float = 60.0,
                 max_frame: int = frames.MAX_FRAME,
                 worker_token: Optional[str] = None):
        remote = tuple(remote)
        if workers < 0:
            raise ValueError("workers must be >= 0")
        if workers + len(remote) < 1:
            raise ValueError("need at least one worker, local or remote")
        if mode not in ("spawn", "thread"):
            raise ValueError(f"unknown shard mode {mode!r}")
        self.mode = mode
        self.remote = tuple(f"{h}:{p}"
                            for h, p in map(_parse_addr, remote))
        self.breaker = breaker or CircuitBreaker(threshold=3,
                                                 cooldown_s=5.0)
        self._io_timeout_s = float(io_timeout_s)
        self._max_frame = int(max_frame)
        self._worker_token = worker_token
        cls = _ProcessWorker if mode == "spawn" else _ThreadWorker
        self.workers: List[_BaseWorker] = []
        try:
            for i in range(workers):
                self.workers.append(cls(i))
            for j, addr in enumerate(remote):
                host, port = _parse_addr(addr)
                self.workers.append(_RemoteWorker(
                    workers + j, host, port, io_timeout_s=io_timeout_s,
                    max_frame=max_frame, token=worker_token))
        except Exception:
            for w in self.workers:   # half-built plane: tear down
                try:
                    w.close()
                except Exception:
                    pass
            raise
        self.n_workers = len(self.workers)
        self._lock = threading.Lock()
        # serializes generation loads against lifecycle adoptions: a
        # recovering worker must hold every generation that is live at
        # the instant it is adopted (no mixed-epoch waves), so re-ship +
        # adopt and load() never interleave
        self._swap_lock = threading.Lock()
        self._gen_seq = 0
        self._gens: Dict[int, _GenState] = {}
        self.loads = 0
        self.retired = 0
        self.slices = 0
        self.slice_errors = 0
        self.fallback_rows = 0
        self.adoptions = 0
        #: set by repro_torch.serve.lifecycle.WorkerSupervisor when attached
        self.supervisor = None
        self._closed = False

    # -- generation lifecycle ------------------------------------------
    def load(self, bank: ModelBank) -> ShardedBank:
        """Split ``bank`` across the workers and load every live one,
        all-or-nothing: any load failure drops what loaded, unlinks the
        shared segments, and re-raises — the caller's swap aborts with
        the incumbent generation untouched. Dead workers are skipped
        (their pairs serve through the parent-side fallback). A card
        bank's kernel library is built here first (:func:`_build_kernels`),
        so no worker process compiles it."""
        with self._swap_lock:
            _build_kernels(bank.device)
            partition = partition_pairs(bank.pairs, self.n_workers)
            sub_banks = bank.split(partition)
            with self._lock:
                self._gen_seq += 1
                gen_id = self._gen_seq
            segments: list = []
            loads: List[Tuple[_BaseWorker, Future]] = []
            try:
                for w, sub in zip(self.workers, sub_banks):
                    if sub is None or not w.alive:
                        continue
                    op, segs = w.prepare_load(gen_id, sub)
                    segments.extend(segs)
                    loads.append((w, w.submit(op)))
                for _, fut in loads:
                    fut.result()
            except Exception:
                for _, fut in loads:   # settle the rest before dropping
                    try:
                        fut.result()
                    except Exception:
                        pass
                for w, _ in loads:
                    if w.alive:
                        w.submit(("drop", gen_id))
                _release_segments(segments, unlink=True)
                raise
            gen = _GenState(gen_id, segments, bank, partition)
            with self._lock:
                self._gens[gen_id] = gen
                self.loads += 1
            return ShardedBank(self, gen, bank, partition)

    def acquire(self, sharded: ShardedBank) -> None:
        with self._lock:
            sharded._gen.active += 1

    def release(self, sharded: ShardedBank) -> None:
        drop = None
        with self._lock:
            gen = sharded._gen
            gen.active -= 1
            if gen.retired and gen.active <= 0 and not gen.dropped:
                gen.dropped = True
                drop = gen
        if drop is not None:
            self._drop(drop)

    def retire(self, sharded: Optional[ShardedBank]) -> None:
        """Mark a generation dead; the drop (worker-side free + segment
        unlink) waits for in-flight waves holding a ref to drain."""
        if sharded is None:
            return
        drop = None
        with self._lock:
            gen = sharded._gen
            gen.retired = True
            self.retired += 1
            if gen.active <= 0 and not gen.dropped:
                gen.dropped = True
                drop = gen
        if drop is not None:
            self._drop(drop)

    def _drop(self, gen: _GenState) -> None:
        for w in self.workers:
            if w.alive:
                w.submit(("drop", gen.gen_id))
        _release_segments(gen.segments, unlink=True)
        with self._lock:
            self._gens.pop(gen.gen_id, None)

    # -- recovery (driven by repro_torch.serve.lifecycle) --------------------
    def live_generations(self) -> List[_GenState]:
        """Generations a recovering worker must hold before adoption
        (everything loaded and not retired)."""
        with self._lock:
            return [g for g in self._gens.values() if not g.retired]

    def build_worker(self, index: int,
                     address: Optional[str] = None) -> _BaseWorker:
        """Construct a *replacement* worker of the same kind as slot
        ``index`` — a fresh process / persona / connection, never a
        resurrection of the old channel (a late reply on a dead socket
        could mispair with the wrong request). TCP replacements re-dial
        the old endpoint unless ``address`` overrides it (a respawned
        ``TcpWorkerPool`` subprocess lands on a new ephemeral port)."""
        old = self.workers[index]
        if old.kind == "spawn":
            return _ProcessWorker(index)
        if old.kind == "thread":
            return _ThreadWorker(index)
        if address is not None:
            host, port = _parse_addr(address)
        else:
            host, port = old.host, old.port
        return _RemoteWorker(index, host, port,
                             io_timeout_s=self._io_timeout_s,
                             max_frame=self._max_frame,
                             token=self._worker_token)

    def adopt_worker(self, index: int, new: _BaseWorker) -> None:
        """Atomically swap ``new`` into slot ``index`` and heal that
        shard's breaker key: the next wave routes the shard's rows off
        the parent fallback path and onto the replacement. The caller
        (the supervisor) must have re-shipped every live generation
        first, under ``_swap_lock``. The old worker object is closed —
        its dispatcher thread joined, its process reaped, its fds
        released — so kill/respawn cycles cannot leak."""
        with self._lock:
            old = self.workers[index]
            self.workers[index] = new
            self.adoptions += 1
        new.suspect = False
        self.breaker.heal(("shard", index))
        if new.kind == "tcp":
            addr = f"{new.host}:{new.port}"
            n_local = self.n_workers - len(self.remote)
            r = index - n_local
            if 0 <= r < len(self.remote):
                self.remote = (self.remote[:r] + (addr,)
                               + self.remote[r + 1:])
        try:
            old.close()
        except Exception:
            pass

    # -- control -------------------------------------------------------
    def kill_worker(self, index: int) -> None:
        """Test/chaos hook: hard-kill one worker."""
        self.workers[index].kill()

    def alive_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive)

    def summary(self) -> dict:
        with self._lock:
            gens = sorted(self._gens)
        out = {
            "mode": self.mode,
            "workers": self.n_workers,
            "worker_kinds": [w.kind for w in self.workers],
            "remote": list(self.remote),
            "alive": self.alive_workers(),
            "generations": gens,
            "loads": self.loads,
            "retired": self.retired,
            "slices": self.slices,
            "slice_errors": self.slice_errors,
            "fallback_rows": self.fallback_rows,
            "adoptions": self.adoptions,
            "auth": self._worker_token is not None,
            "breaker_open": [list(k) for k in self.breaker.open_keys()],
        }
        if self.supervisor is not None:
            out["lifecycle"] = self.supervisor.summary()
        return out

    def close(self) -> None:
        """Tear the plane down: exit workers, join threads/processes,
        unlink every surviving generation's segments."""
        if self._closed:
            return
        self._closed = True
        if self.supervisor is not None:
            try:
                self.supervisor.stop()
            except Exception:
                pass
        for w in self.workers:
            try:
                w.close()
            except Exception:
                pass
        with self._lock:
            gens = list(self._gens.values())
            self._gens.clear()
        for gen in gens:
            _release_segments(gen.segments, unlink=True)

    def __enter__(self) -> "ShardPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

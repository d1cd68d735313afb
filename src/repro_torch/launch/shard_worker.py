"""``repro_torch.launch.shard_worker`` — run one TCP shard worker.

The remote half of the multi-host shard plane: binds a
:class:`repro_torch.serve.shard.WorkerServer` and serves the framed
``load``/``exec``/``drop``/``ping`` protocol until interrupted. Prints
``listening HOST:PORT`` (the bound address — port 0 means an ephemeral
pick) as its first stdout line so launchers can parse where to connect::

    python -m repro_torch.launch.shard_worker --host 0.0.0.0 --port 7421

Banks it receives run on ``--device`` (default ``cuda``: the grouped
forest kernel on the card; ``cpu`` runs the plain PyTorch path). Point a
serving parent at it with ``serve_http --remote-worker HOST:7421`` (or
``ShardPlane(remote=["HOST:7421"])``). The worker holds no durable state —
banks arrive per generation over the wire and die with the connection — so
restarting one is always safe.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional, Sequence

from repro_torch.serve import frames
from repro_torch.serve.shard import WorkerServer


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve one PROFET shard worker over TCP.")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback)")
    ap.add_argument("--port", type=int, default=0,
                    help="bind port; 0 picks an ephemeral port")
    ap.add_argument("--max-frame", type=int, default=frames.MAX_FRAME,
                    help="per-frame size ceiling in bytes")
    ap.add_argument("--token", default=None,
                    help="pre-shared handshake token; a parent whose "
                         "HELLO ack fails the constant-time compare is "
                         "closed before any load is processed (defaults "
                         "to $PROFET_WORKER_TOKEN; empty = no auth)")
    ap.add_argument("--device", default="cuda",
                    help="where received banks run (cuda or cpu)")
    args = ap.parse_args(argv)
    token = args.token if args.token is not None \
        else os.environ.get("PROFET_WORKER_TOKEN")
    if not token:                 # empty string disables auth too
        token = None

    server = WorkerServer(args.host, args.port, max_frame=args.max_frame,
                          token=token, device=args.device)
    print(f"listening {server.host}:{server.port}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except (ValueError, OSError):
            pass                # non-main thread / unsupported platform
    try:
        stop.wait()
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

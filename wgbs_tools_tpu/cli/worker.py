"""Persistent worker: one long-lived process serves many CLI invocations.

Why: the reference has no compile step — its binaries are compiled once at
install (ref: setup.py:41-69) and every process starts cold in ~0 s. A
fresh process of ours pays JAX start-up, device initialization and the
load of its compiled programs from the persistent compilation cache
(cli/main.py::ensure_compile_cache) before its first device step. The
worker pays them once: loaded executables and the device client live as
long as the worker process, so every later invocation starts warm. It
also keeps one process on the card, which the card needs (a JAX process
reserves most of the device memory when it starts).

Usage:
    wgbstools-tpu worker serve [--socket PATH]     # long-lived server
    wgbstools-tpu worker run <cmd> [args...]       # run through the worker
    wgbstools-tpu worker stop                      # ask the server to exit
    WGBS_TPU_WORKER=1 wgbstools-tpu <cmd> ...      # transparent routing

Protocol (unix socket, single client at a time): the client sends one JSON
line {"argv": [...], "cwd": "...", "env": {WGBS_*...}}; the server streams
framed output back — 1-byte type (1=stdout, 2=stderr, 0=exit) + 4-byte LE
length + payload — and the client replays frames onto its own streams and
exits with the command's return code. stdin is not forwarded.

Concurrency: requests are served STRICTLY ONE AT A TIME (device state —
compiled executables, the card's memory — is process-global, so
serializing is the correct semantics, not a shortcut). Additional clients
queue in the socket's accept backlog (depth 8) and block until the running
request finishes. A client falls back to in-process execution only when no
worker is listening; when a worker exists but cannot be reached, the
client refuses rather than open the card the worker holds. Trust model:
the socket is protected only by filesystem permissions on its directory
(0700 ~/.cache/wgbs_tpu by default) — do not point WGBS_TPU_WORKER_SOCKET
at a world-writable directory.
"""

import argparse
import json
import os
import os.path as op
import socket
import struct
import sys

DEFAULT_SOCKET = op.join(op.expanduser("~"), ".cache", "wgbs_tpu",
                         "worker.sock")


def socket_path():
    return os.environ.get("WGBS_TPU_WORKER_SOCKET", DEFAULT_SOCKET)


class _FrameWriter:
    """File-like that frames writes onto the socket."""

    def __init__(self, sock, kind):
        self.sock = sock
        self.kind = kind

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        if data:
            self.sock.sendall(struct.pack("<BI", self.kind, len(data)) + data)
        return len(data)

    def flush(self):
        pass

    @property
    def buffer(self):
        return self

    def isatty(self):
        return False


def _serve_one(conn):
    """Run one request; returns False when the client asked us to stop."""
    buf = b""
    while b"\n" not in buf:
        chunk = conn.recv(65536)
        if not chunk:
            return True
        buf += chunk
    req = json.loads(buf.split(b"\n", 1)[0])
    if req.get("stop"):
        conn.sendall(struct.pack("<BI", 0, 4) + struct.pack("<i", 0))
        return False

    argv = req["argv"]
    out = _FrameWriter(conn, 1)
    err = _FrameWriter(conn, 2)
    old = (sys.stdout, sys.stderr, os.getcwd())
    saved_env = {}
    try:
        if req.get("cwd"):
            os.chdir(req["cwd"])
        client_env = req.get("env") or {}
        # the client's WGBS_* view replaces the server's entirely: a WGBS_*
        # var set in the server's own environment but absent from the
        # client's must not leak into the request
        for k in list(os.environ):
            if (k.startswith("WGBS_") and k not in client_env
                    and k not in ("WGBS_TPU_WORKER", "WGBS_TPU_WORKER_SOCKET")):
                saved_env[k] = os.environ.pop(k)
        for k, v in client_env.items():
            # never apply the routing vars inside the server: a forwarded
            # WGBS_TPU_WORKER=1 would make the worker dial its own socket
            if k in ("WGBS_TPU_WORKER", "WGBS_TPU_WORKER_SOCKET"):
                continue
            saved_env.setdefault(k, os.environ.get(k))
            os.environ[k] = v
        sys.stdout, sys.stderr = out, err
        from .main import main as cli_main

        try:
            rc = cli_main(argv)
        except SystemExit as e:  # argparse exits
            rc = int(e.code or 0)
        except BaseException:
            import traceback

            err.write(traceback.format_exc())
            rc = 1
    finally:
        sys.stdout, sys.stderr = old[0], old[1]
        try:
            os.chdir(old[2])
        except OSError:
            pass
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    conn.sendall(struct.pack("<BI", 0, 4) + struct.pack("<i", int(rc or 0)))
    return True


def _warm_compiles():
    """Run the device pileup once on a tiny synthetic batch so the FIRST
    client job finds its executable loaded."""
    import numpy as np

    from ..ops.pileup import pileup_frags
    from ..formats.pat import PatFrags

    n = 1 << 12
    rng = np.random.default_rng(0)
    start = np.sort(rng.integers(1, n - 20, size=256)).astype(np.int64)
    length = rng.integers(1, 12, size=256).astype(np.int64)
    codes = rng.integers(0, 2, size=(256, 12)).astype(np.uint8)
    codes[np.arange(12)[None, :] >= length[:, None]] = 3
    frags = PatFrags(start, length, np.ones(256, np.int64), codes,
                     np.zeros(256, np.int16), ["chr1"], None)
    pileup_frags(frags, (1, n + 1))


def serve(path=None, warm=False):
    path = path or socket_path()
    os.makedirs(op.dirname(path), mode=0o700, exist_ok=True)
    if op.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)  # owner-only even under a permissive umask
    srv.listen(8)  # waiting clients queue here (served one at a time)
    from ..utils.log import logger

    from .main import ensure_compile_cache

    ensure_compile_cache()
    if warm:
        logger.info("worker: warming device compiles...")
        _warm_compiles()
    logger.info("worker: serving on %s (pid %d)", path, os.getpid())
    try:
        while True:
            conn, _ = srv.accept()
            try:
                if not _serve_one(conn):
                    break
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-command; keep serving
            finally:
                conn.close()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass
    return 0


def run_via_worker(argv, path=None, stop=False):
    """Client: run argv on the worker; returns its rc, or None when no
    worker is listening (the caller then runs in-process). A worker that
    exists but cannot be reached gets rc 1 and a message: running
    in-process then would open the card the worker holds."""
    path = path or socket_path()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.connect(path)
    except (FileNotFoundError, ConnectionRefusedError):
        s.close()
        return None
    except OSError as e:
        s.close()
        print(f"worker at {path} is busy or unreachable ({e}); not running "
              "in-process while it holds the device", file=sys.stderr)
        return 1
    req = {"argv": argv, "cwd": os.getcwd(), "stop": stop,
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith("WGBS_")}}
    try:
        s.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while True:
            while len(buf) < 5:
                chunk = s.recv(1 << 20)
                if not chunk:
                    return 1  # server died mid-stream
                buf += chunk
            kind, ln = struct.unpack("<BI", buf[:5])
            buf = buf[5:]
            while len(buf) < ln:
                chunk = s.recv(1 << 20)
                if not chunk:
                    return 1
                buf += chunk
            payload, buf = buf[:ln], buf[ln:]
            if kind == 0:
                return struct.unpack("<i", payload)[0]
            stream = sys.stdout if kind == 1 else sys.stderr
            try:
                stream.buffer.write(payload)
                stream.buffer.flush()
            except AttributeError:  # text-only stream (tests)
                stream.write(payload.decode(errors="replace"))
    finally:
        s.close()


def main(argv):
    # NOTE: `run` forwards everything after it verbatim (argparse would
    # swallow the wrapped command's --help), so only serve/stop use argparse
    if argv and argv[0] == "run":
        rest = list(argv[1:])
        path = None
        if rest[:1] == ["--socket"] and len(rest) >= 2:
            path, rest = rest[1], rest[2:]
        rc = run_via_worker(rest, path=path)
        if rc is None:
            print("no worker running; start one with `worker serve`",
                  file=sys.stderr)
            return 1
        return rc
    p = argparse.ArgumentParser(
        prog="worker",
        description="Persistent worker: keep one process (and its device "
        "compiles) alive across CLI invocations")
    p.add_argument("verb", choices=["serve", "run", "stop"])
    p.add_argument("--socket", default=None)
    p.add_argument("--warm", action="store_true",
                   help="compile the device pileup at startup so the first "
                        "client job runs warm")
    args = p.parse_args(argv)
    if args.verb == "serve":
        return serve(args.socket, warm=args.warm)
    rc = run_via_worker([], path=args.socket, stop=True)
    if rc is None:
        print("no worker running", file=sys.stderr)
        return 1
    return 0

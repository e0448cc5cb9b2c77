"""Daemon mode: keep the device, compiled kernels and the resident
database warm across CLI invocations.

Users run sift4g repeatedly over query sets; a fresh process pays device
start-up, compiles (or compile-cache loads) and the resident-database
upload every time.  ``sift4g-tpu --serve SOCKET`` starts a single
long-lived process that owns the device (one JAX process per card: a
second one would fail to reserve the card's memory) and executes
pipeline jobs submitted over a UNIX domain socket.  ``sift4g-tpu
--connect SOCKET <normal flags>`` ships the invocation to the daemon and
never imports JAX; compiled executables persist in the daemon's jit
caches, so the second and later jobs skip every compile whose shape was
already seen (the geometric padded-length ladder in align/batch.py keeps
the shape universe small precisely so this converges).

Protocol: the client sends one JSON line — {"argv": [...]} — and the
daemon answers with a STREAM of JSON lines: zero or more {"log": "..."}
frames carrying the job's stderr incrementally (progress meters included,
mirroring the reference's live carriage-return meters, utils.cpp:52-61;
a 400-second job shows progress, not silence), then one final
{"status": int, "job": int, "elapsed_s": float}.  Jobs run serially (the
device is one serial resource); output files are written by the daemon
process to the job's --out directory as usual.

Robustness: every socket write is guarded — a
client that dies or times out mid-job (cold connects run minutes) flips
the connection to drop mode and the job RUNS TO COMPLETION (its output
files are the product; the log keeps flowing to the daemon's own stderr
fallback), and the daemon survives to serve the next connection.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time

# per-connection socket timeout: bounds how long a write to a wedged
# (alive-but-not-reading) client can stall the job's log flush before the
# connection is declared dead; also bounds the initial request read
_CONN_TIMEOUT_S = 30.0


class _SocketLog:
    """File-like stderr stand-in that streams chunks to the client as
    {"log": ...} frames.  A failed write (dead/wedged client) permanently
    flips to drop mode — the job must never die on the client's account;
    subsequent log text goes to ``fallback`` (the daemon's own stderr)."""

    def __init__(self, sock_file, fallback):
        self._f = sock_file
        self._fallback = fallback
        self.dead = False
        self._buf = []
        self._buffered = 0

    def write(self, s: str) -> int:
        if not s:
            return 0
        self._buf.append(s)
        self._buffered += len(s)
        # meters end in \r, phase banners in \n: flush on either so the
        # client renders progress live; cap buffering for raw writes
        if "\n" in s or "\r" in s or self._buffered > 4096:
            self.flush()
        return len(s)

    def flush(self) -> None:
        if not self._buf:
            return
        chunk = "".join(self._buf)
        self._buf.clear()
        self._buffered = 0
        if self.dead:
            self._fallback.write(chunk)
            self._fallback.flush()
            return
        try:
            self._f.write(json.dumps({"log": chunk}).encode() + b"\n")
            self._f.flush()
        except (OSError, ValueError):  # dead client / closed file
            self.dead = True
            self._fallback.write(
                "* client connection lost; job continues, log follows *\n"
            )
            self._fallback.write(chunk)
            self._fallback.flush()


def _strip_flag(argv, flag, has_value=True):
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            i += 2 if has_value else 1
            continue
        if has_value and a.startswith(flag + "="):
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _serve_one(conn, jobs: int, real_stderr) -> "tuple[int, bool]":
    """Handle one connection.  Returns (jobs, shutdown_requested).
    Raises nothing: all socket errors are contained here."""
    from . import cli

    conn.settimeout(_CONN_TIMEOUT_S)
    f = conn.makefile("rwb")

    def _reply(obj) -> None:
        try:
            f.write(json.dumps(obj).encode() + b"\n")
            f.flush()
        except (OSError, ValueError):
            pass  # dead client: the reply has nowhere to go

    try:
        line = f.readline()
    except OSError:
        return jobs, False
    if not line:
        return jobs, False
    try:
        req = json.loads(line)
    except ValueError:
        _reply({"status": -1, "error": "bad request"})
        return jobs, False
    if req.get("shutdown"):
        _reply({"status": 0, "job": jobs})
        return jobs, True

    argv = req.get("argv", [])
    # the daemon owns platform selection and must not recurse
    for flag in ("--platform", "--serve", "--connect"):
        argv = _strip_flag(argv, flag)
    jobs += 1
    t0 = time.perf_counter()
    log = _SocketLog(f, real_stderr)
    old_stderr, sys.stderr = sys.stderr, log
    # per-job env isolation: flags like --cache-dir export env vars for
    # the pipeline's benefit; a job's export must not leak into the NEXT
    # job's behavior (identical argv must behave the same one-shot vs
    # under the daemon)
    _job_env = ("SIFT4G_TPU_CACHE_DIR",)
    env_before = {k: os.environ.get(k) for k in _job_env}
    try:
        status = cli.main(argv)
    except SystemExit as exc:
        status = int(exc.code or 0)
    except Exception as exc:  # job errors must not kill the daemon
        print(f"error: {exc}", file=log)
        status = -1
    finally:
        sys.stderr = old_stderr
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        try:
            log.flush()
        except Exception:
            pass
    _reply({
        "status": status,
        "job": jobs,
        "elapsed_s": round(time.perf_counter() - t0, 3),
    })
    return jobs, False


def serve_forever(socket_path: str, platform: str = "auto") -> int:
    """Run the job loop until SIGTERM/SIGINT.  Returns exit status."""
    if platform != "auto":
        import jax

        jax.config.update("jax_platforms", platform)
    from .utils import enable_compile_cache

    enable_compile_cache()

    # jobs can detect daemon context (e.g. knobs that trade per-job setup
    # against cross-job warmth)
    os.environ["SIFT4G_TPU_IN_DAEMON"] = "1"

    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(8)
    print(f"** sift4g-tpu daemon listening on {socket_path} **",
          file=sys.stderr)

    jobs = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    jobs, shutdown = _serve_one(conn, jobs, sys.stderr)
                except OSError:
                    continue  # connection-level failure: next client
            if shutdown:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def submit(socket_path: str, argv, shutdown: bool = False) -> int:
    """Ship one invocation to the daemon; relay its streamed log frames
    live to stderr; return the job's exit status."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        c.connect(socket_path)
    except OSError as exc:
        print(f"error: cannot reach daemon at '{socket_path}': {exc}",
              file=sys.stderr)
        return -1
    reply = None
    with c:
        f = c.makefile("rwb")
        req = {"argv": list(argv)}
        if shutdown:
            req["shutdown"] = True
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        for line in f:
            try:
                msg = json.loads(line)
            except ValueError:
                # truncated/corrupt frame (daemon killed mid-write):
                # treat as a severed stream, not a client traceback
                break
            if "status" in msg:
                reply = msg
                break
            if "log" in msg:  # incremental job stderr
                sys.stderr.write(msg["log"])
                sys.stderr.flush()
    if reply is None:
        print("error: daemon closed the connection", file=sys.stderr)
        return -1
    if not shutdown:
        print(
            f"** job {reply.get('job')} done in {reply.get('elapsed_s')}s "
            f"(status {reply.get('status')}) **",
            file=sys.stderr,
        )
    return int(reply.get("status", -1))

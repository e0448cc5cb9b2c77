"""Daemon mode: jobs submitted over the UNIX socket produce golden
outputs, reuse one process (job counter), and shut down cleanly
(sift4g_tpu/serve.py)."""

import filecmp
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

TEST_FILES = "/root/reference/test_files"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TEST_FILES), reason="reference test files not mounted"
)


def _wait_socket(path, proc, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(
                f"daemon died: {proc.stderr.read().decode()}"
            )
        if os.path.exists(path):
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                c.connect(path)
                c.close()
                return
            except OSError:
                pass
        time.sleep(0.2)
    raise AssertionError("daemon socket never came up")


def _submit(sock_path, payload):
    """Submit a request and drain the framed reply stream: {"log": ...}
    frames then the final status frame.  Returns the final frame with the
    concatenated log re-attached under "log" plus the frame count under
    "n_log_frames" (streaming-order assertions)."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock_path)
    f = c.makefile("rwb")
    f.write(json.dumps(payload).encode() + b"\n")
    f.flush()
    logs, reply = [], None
    for line in f:
        msg = json.loads(line)
        if "status" in msg:
            reply = msg
            break
        logs.append(msg.get("log", ""))
    c.close()
    assert reply is not None, "daemon closed the stream without a status"
    reply["log"] = "".join(logs)
    reply["n_log_frames"] = len(logs)
    return reply


def test_daemon_serves_jobs_and_shuts_down(tmp_path):
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sift4g_tpu", "--serve", sock,
         "--platform", "cpu"],
        stderr=subprocess.PIPE, env=env,
    )
    try:
        _wait_socket(sock, proc)

        out1 = tmp_path / "o1"
        out2 = tmp_path / "o2"
        out1.mkdir()
        out2.mkdir()
        base = [
            "-q", os.path.join(TEST_FILES, "query.fasta"),
            "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
            "--subst", TEST_FILES, "--backend", "numpy",
        ]
        r1 = _submit(sock, {"argv": base + ["--out", str(out1)]})
        assert r1["status"] == 0, r1.get("log")
        assert r1["job"] == 1
        # client-side flags must be stripped, not recursed
        r2 = _submit(
            sock,
            {"argv": base + ["--out", str(out2), "--platform", "gpu"]},
        )
        assert r2["status"] == 0, r2.get("log")
        assert r2["job"] == 2, "daemon must persist across jobs"
        assert "SIFT predictions" in r2["log"]
        # the log STREAMS: phase banners arrive as separate frames ahead
        # of the final status, not one blob at completion
        assert r2["n_log_frames"] >= 2

        for out in (out1, out2):
            for name in ("LACI_ECOLI", "PURR_SALTY"):
                assert filecmp.cmp(
                    out / f"{name}.SIFTprediction",
                    os.path.join(GOLDEN, f"{name}.SIFTprediction"),
                    shallow=False,
                )

        # a failing job must not kill the daemon
        r3 = _submit(sock, {"argv": ["-q", "/does/not/exist"]})
        assert r3["status"] != 0
        r4 = _submit(sock, {"shutdown": True})
        assert r4["status"] == 0
        proc.wait(timeout=30)
        assert proc.returncode == 0
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=10)


def test_daemon_survives_client_disconnect_midjob(tmp_path):
    """A client that dies mid-job (the kill -9 scenario) must not take
    the daemon down; the abandoned job runs to
    completion (its output files appear) and the next client is served."""
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sift4g_tpu", "--serve", sock,
         "--platform", "cpu"],
        stderr=subprocess.PIPE, env=env,
    )
    try:
        _wait_socket(sock, proc)
        out1 = tmp_path / "o1"
        out2 = tmp_path / "o2"
        out1.mkdir()
        out2.mkdir()
        base = [
            "-q", os.path.join(TEST_FILES, "query.fasta"),
            "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
            "--subst", TEST_FILES, "--backend", "numpy",
        ]
        # start a job, read ONE streamed frame (proof the job is running),
        # then vanish without reading the rest
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(sock)
        f = c.makefile("rwb")
        f.write(json.dumps(
            {"argv": base + ["--out", str(out1)]}
        ).encode() + b"\n")
        f.flush()
        first = f.readline()
        assert b"log" in first
        c.close()  # abrupt disconnect mid-job

        # the daemon must serve the next client normally
        r2 = _submit(sock, {"argv": base + ["--out", str(out2)]})
        assert r2["status"] == 0, r2.get("log")
        assert r2["job"] == 2
        # and the abandoned job completed its outputs
        for name in ("LACI_ECOLI", "PURR_SALTY"):
            assert (out1 / f"{name}.SIFTprediction").is_file()
            assert filecmp.cmp(
                out1 / f"{name}.SIFTprediction",
                os.path.join(GOLDEN, f"{name}.SIFTprediction"),
                shallow=False,
            )
        assert _submit(sock, {"shutdown": True})["status"] == 0
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=10)


def test_connect_cli_roundtrip(tmp_path):
    """The --connect client ships a job and relays the daemon's log."""
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sift4g_tpu", "--serve", sock,
         "--platform", "cpu"],
        stderr=subprocess.PIPE, env=env,
    )
    try:
        _wait_socket(sock, proc)
        out = tmp_path / "o"
        out.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", "sift4g_tpu", "--connect", sock,
             "-q", os.path.join(TEST_FILES, "query.fasta"),
             "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
             "--out", str(out), "--backend", "numpy"],
            capture_output=True, timeout=120, env=env,
        )
        assert res.returncode == 0, res.stderr.decode()
        assert b"job 1 done" in res.stderr
        assert (out / "LACI_ECOLI.SIFTprediction").is_file()
        shut = subprocess.run(
            [sys.executable, "-m", "sift4g_tpu", "--connect", sock,
             "--shutdown"],
            capture_output=True, timeout=60, env=env,
        )
        assert shut.returncode == 0
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=10)


def test_daemon_jobs_do_not_leak_cache_dir(tmp_path):
    """--cache-dir in job 1 must not change job 2's cache layout (the
    flag exports SIFT4G_TPU_CACHE_DIR; serve restores per-job env)."""
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("SIFT4G_TPU_CACHE_DIR", None)
    # job 2 reads a COPY of the database in a writable dir so the default
    # next-to-input layout is observable
    import shutil

    db2_dir = tmp_path / "db2"
    db2_dir.mkdir()
    for f in ("query.fasta", "sample_protein_database.fa"):
        shutil.copy(os.path.join(TEST_FILES, f), db2_dir / f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sift4g_tpu", "--serve", sock,
         "--platform", "cpu"],
        stderr=subprocess.PIPE, env=env,
    )
    try:
        _wait_socket(sock, proc)
        out1 = tmp_path / "o1"
        out2 = tmp_path / "o2"
        cache1 = tmp_path / "cache1"
        out1.mkdir()
        out2.mkdir()
        r1 = _submit(sock, {"argv": [
            "-q", os.path.join(TEST_FILES, "query.fasta"),
            "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
            "--backend", "numpy", "--out", str(out1),
            "--cache-dir", str(cache1),
        ]})
        assert r1["status"] == 0, r1.get("log")
        assert [f for f in os.listdir(cache1) if f.endswith(".s4gc")]
        r2 = _submit(sock, {"argv": [
            "-q", str(db2_dir / "query.fasta"),
            "-d", str(db2_dir / "sample_protein_database.fa"),
            "--backend", "numpy", "--out", str(out2),
        ]})
        assert r2["status"] == 0, r2.get("log")
        # job 2's caches landed next to ITS inputs, not in job 1's dir
        assert (db2_dir / "sample_protein_database.fa.s4gc").exists()
        assert not [
            f for f in os.listdir(cache1) if "sample" in f and "db2" in f
        ]
        assert _submit(sock, {"shutdown": True})["status"] == 0
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=10)

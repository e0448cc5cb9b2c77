"""Multi-host harness: 2 processes x 4 virtual devices, byte-identical output.

real ``jax.distributed.initialize`` (Gloo collectives),
record-aligned per-host database shards with global index offsets, O(k)
candidate/winner merges under the (score desc, id asc) total order, host-0
only writers — and the outputs must byte-equal the single-process run on
the bundled reference test set and on a synthetic database.

These spawn real subprocesses (the CPU analogue of one-process-per-host);
they are the heaviest tests in the suite.
"""

import filecmp
import os
import socket
import subprocess
import sys

import pytest

TEST_FILES = "/root/reference/test_files"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DRIVER = os.path.join(os.path.dirname(__file__), "mh_driver.py")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TEST_FILES), reason="reference test files not mounted"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_multihost(cli_args, timeout=420, extra_env=None):
    """Spawn 2 driver processes; returns after both exit 0."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [sys.executable, DRIVER, str(pid), "2", str(port)] + cli_args,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=os.path.dirname(os.path.dirname(DRIVER)),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"driver failed rc={rc}\n{err.decode()[-3000:]}"


def test_multihost_bundled_testset_matches_goldens(tmp_path):
    out = tmp_path / "mh"
    out.mkdir()
    _run_multihost([
        "-q", os.path.join(TEST_FILES, "query.fasta"),
        "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
        "--subst", TEST_FILES,
        "--out", str(out),
        "--backend", "numpy",
    ])
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = out / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_shard_merge_equals_single_process_candidates(tmp_path):
    """Single-process unit test (no subprocesses): sharded prefilter +
    _merge_candidates reproduces the unsharded candidate sets exactly, for
    every host count — the determinism the subprocess tests rely on."""
    import numpy as np

    from sift4g_tpu.io.fasta import read_fasta
    from sift4g_tpu.parallel.multihost import (
        _merge_candidates,
        shard_record_ranges,
    )
    from sift4g_tpu.prefilter.search import search_database

    rng = np.random.default_rng(7)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    db = tmp_path / "db.fa"
    with open(db, "wb") as fh:
        for i in range(300):
            seq = rng.choice(aas, size=int(rng.integers(40, 300))).tobytes()
            fh.write(b">s%d\n%s\n" % (i, seq))
    q = tmp_path / "q.fa"
    with open(q, "wb") as fh:
        for i in range(3):
            seq = rng.choice(aas, size=120).tobytes()
            fh.write(b">q%d\n%s\n" % (i, seq))
    queries = read_fasta(str(q))
    devnull = open(os.devnull, "w")

    want, want_cells = search_database(
        str(db), queries, max_candidates=50, log=devnull
    )

    for n_hosts in (2, 3):
        ranges = shard_record_ranges(str(db), n_hosts)
        assert ranges[0][0] == 0 and ranges[-1][1] == 300
        assert all(ranges[h][1] == ranges[h + 1][0] for h in range(n_hosts - 1))
        per_host, cells = [], 0
        for lo, hi in ranges:
            _ix, c, scored = search_database(
                str(db), queries, max_candidates=50, log=devnull,
                record_range=(lo, hi), return_scored=True,
            )
            cells += c
            per_host.append(scored)
            for _s, ids in scored:  # shard ids are global and in-shard
                assert ((ids >= lo) & (ids < hi)).all()
        merged = _merge_candidates(per_host, len(queries), 50)
        assert cells == want_cells
        for got_q, want_q in zip(merged, want):
            assert np.array_equal(got_q, want_q)


def test_multihost_synthetic_db_matches_single_process(tmp_path):
    """Sharded 2-host run == single-process run on a synthetic database
    (sub-results on, so the alignment report's scores/coords/order are
    byte-compared too)."""
    data = tmp_path / "data"
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.dirname(DRIVER)),
                                      "tools", "make_synthetic_db.py"),
         str(data), "--n-db", "20000", "--n-q", "4", "--mean-len", "220"],
        check=True, capture_output=True,
        cwd=os.path.dirname(os.path.dirname(DRIVER)),
    )
    q, db = str(data / "queries.fa"), str(data / "db.fa")

    single = tmp_path / "single"
    single.mkdir()
    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        query_path=q, database_path=db, out_path=str(single),
        align_backend="native", sub_results=True,
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)

    multi = tmp_path / "multi"
    multi.mkdir()
    _run_multihost([
        "-q", q, "-d", db, "--out", str(multi),
        "--backend", "native", "--sub-results",
    ])

    # the run manifest (.sift4g_tpu_run.json) is written by run_pipeline
    # only; compare the pipeline OUTPUTS
    names = sorted(f for f in os.listdir(single) if not f.startswith("."))
    assert names and names == sorted(
        f for f in os.listdir(multi) if not f.startswith(".")
    )
    for name in names:
        assert filecmp.cmp(single / name, multi / name, shallow=False), (
            f"{name} differs between single-process and 2-host runs"
        )


def test_multihost_query_sharded_matches_goldens(tmp_path):
    """--mh-shard queries: each host owns a contiguous query slice end to
    end (the missense/proteome mode).  With 2 hosts and the 2-query bundled
    set, each host processes exactly one query; the union of per-host
    output files must byte-equal the goldens."""
    out = tmp_path / "mhq"
    out.mkdir()
    _run_multihost([
        "-q", os.path.join(TEST_FILES, "query.fasta"),
        "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
        "--subst", TEST_FILES,
        "--out", str(out),
        "--backend", "numpy",
        "--mh-shard", "queries",
    ])
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = out / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_multihost_screened_resident_matches_oracle(tmp_path):
    """The multihost workload covers the production screened + resident +
    DEVICE-PREDICT config.  2 hosts run backend=pallas (the GPU kernel in
    interpret mode on CPU meshes) with --resident-db on, device-side
    screening active
    (default), and --predict-backend device; the queries carry .subst
    files so the device path is the f32-screen + sparse-f64 hybrid whose
    outputs are byte-identical — everything must byte-equal a
    single-process NumPy-oracle host-predict run."""
    data = tmp_path / "data"
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.dirname(DRIVER)),
                                      "tools", "make_synthetic_db.py"),
         str(data), "--n-db", "6000", "--n-q", "3", "--mean-len", "220",
         "--subst-per-query", "4"],
        check=True, capture_output=True,
        cwd=os.path.dirname(os.path.dirname(DRIVER)),
    )
    q, db = str(data / "queries.fa"), str(data / "db.fa")

    single = tmp_path / "single"
    single.mkdir()
    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        query_path=q, database_path=db, out_path=str(single),
        align_backend="numpy", max_candidates=300, sub_results=True,
        subst_path=str(data),
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)

    multi = tmp_path / "multi"
    multi.mkdir()
    _run_multihost(
        ["-q", q, "-d", db, "--out", str(multi),
         "--backend", "pallas", "--resident-db", "on",
         "--subst", str(data), "--predict-backend", "device",
         "--max-candidates", "300", "--sub-results"],
    )

    # the run manifest (.sift4g_tpu_run.json) is written by run_pipeline
    # only; compare the pipeline OUTPUTS
    names = sorted(f for f in os.listdir(single) if not f.startswith("."))
    assert names and names == sorted(
        f for f in os.listdir(multi) if not f.startswith(".")
    )
    for name in names:
        assert filecmp.cmp(single / name, multi / name, shallow=False), (
            f"{name} differs between oracle single-process and the "
            f"screened resident 2-host run"
        )

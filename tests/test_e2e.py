"""Golden end-to-end regression on the bundled reference test data.

The reference binary cannot be built in this snapshot (the swsharp
submodule is empty), so the goldens were produced by this framework's
float64 NumPy semantic path after line-by-line verification against the
reference sources, and are locked here as regression oracles.  Both
backends must reproduce them byte-for-byte.
"""

import filecmp
import os

import pytest

from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

TEST_FILES = "/root/reference/test_files"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TEST_FILES), reason="reference test files not mounted"
)


def run(tmp_path, backend, subst, sub_results=False):
    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES if subst else "",
        out_path=str(tmp_path),
        align_backend=backend,
        sub_results=sub_results,
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)


@pytest.mark.parametrize("backend", ["numpy", "xla"])
def test_subst_predictions_golden(tmp_path, backend):
    run(tmp_path, backend, subst=True)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


@pytest.mark.parametrize("backend", ["numpy", "xla"])
def test_matrix_predictions_golden(tmp_path, backend):
    run(tmp_path, backend, subst=False, sub_results=True)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.matrix.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"
    assert filecmp.cmp(
        tmp_path / "LACI_ECOLI.aligned.fasta",
        os.path.join(GOLDEN, "LACI_ECOLI.aligned.fasta"),
        shallow=False,
    )
    assert filecmp.cmp(
        tmp_path / "alignments.txt", os.path.join(GOLDEN, "alignments.txt"),
        shallow=False,
    )


def test_pallas_grouped_backend_golden(tmp_path, monkeypatch):
    """The grouped GPU-kernel path (production GPU config) reproduces
    goldens.

    On the CPU test mesh the pallas backend normally routes through the
    sharded scorer; pin the single-device path by stripping the mesh; the
    kernel runs in Pallas interpret mode.
    """
    import sift4g_tpu.align.batch as batch_mod

    orig_init = batch_mod.BatchAligner.__init__

    def no_mesh_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self._mesh = None

    monkeypatch.setattr(batch_mod.BatchAligner, "__init__", no_mesh_init)
    run(tmp_path, "pallas", subst=True)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_chunked_alignment_matches(tmp_path):
    """Tiny streaming chunks must not change any output (cross-chunk merge)."""
    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(tmp_path),
        align_backend="numpy",
        search_chunk_bytes=500,
        align_chunk_bytes=700,
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_native_backend_golden(tmp_path):
    """Threaded C++ score backend (CPU deployments) reproduces goldens."""
    run(tmp_path, "native", subst=True)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


@pytest.mark.parametrize("algorithm", ["NW", "HW", "OV"])
def test_other_algorithms_golden(tmp_path, algorithm):
    """Non-default aligner modes byte-match their frozen e2e goldens
    (reference accepts all four algorithms,
    main.cpp:51-56,275-284).  Goldens generated by the float64 NumPy
    path; the NW set is independently re-derived by the scalar second
    oracle (test_second_oracle.py)."""
    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(tmp_path),
        align_backend="numpy",
        algorithm=algorithm,
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.{algorithm}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} {algorithm}"


def test_device_predict_backend_matrix_mode(tmp_path):
    """--predict-backend device: matrix-mode outputs agree with the golden
    float64 matrices to one printed digit (the device path is float32 and
    documented non-bit-parity; sift/predict_batch.py)."""
    import numpy as np

    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path="",
        out_path=str(tmp_path),
        align_backend="numpy",
        predict_backend="device",
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)

    def parse(path):
        vals = []
        with open(path) as fp:
            for line in fp:
                parts = line.split()
                if parts and parts[0] not in ("ID", "AC", "DE", "MA", "//") \
                        and not parts[0].isalpha():
                    vals.append([float(x) for x in parts])
        return np.asarray(vals)

    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = parse(tmp_path / f"{name}.SIFTprediction")
        want = parse(os.path.join(GOLDEN, f"{name}.matrix.SIFTprediction"))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1.5e-4)


def test_device_predict_backend_subst_byte_identical(tmp_path):
    """Subst-mode queries under --predict-backend device ride the
    f32-screen + sparse-f64 hybrid (sift/predict_subst.py) and stay
    byte-identical to the host-oracle goldens."""
    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(tmp_path),
        align_backend="numpy",
        predict_backend="device",
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"


def test_resume_skips_existing_and_matches_full_run(tmp_path):
    """--resume (pipeline.py cfg.resume): completed queries are skipped,
    missing ones regenerate byte-identically to a full run (queries are
    independent end to end; E-value params depend only on db size)."""
    full = tmp_path / "full"
    part = tmp_path / "part"
    full.mkdir()
    part.mkdir()
    run(full, "numpy", subst=True)
    names = sorted(
        p for p in os.listdir(full) if p.endswith(".SIFTprediction")
    )
    assert len(names) == 2

    # seed the resume dir with ONE completed output, then resume
    (part / names[0]).write_bytes((full / names[0]).read_bytes())
    import sys

    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(part),
        align_backend="numpy",
        resume=True,
        log=open(os.devnull, "w"),
    )
    queries = run_pipeline(cfg)
    assert len(queries) == 1  # only the missing query was processed
    for name in names:
        assert filecmp.cmp(full / name, part / name, shallow=False), name

    # resuming a complete dir processes nothing
    assert run_pipeline(cfg) == []


def test_resume_crash_safety(tmp_path):
    """A run killed mid-write can leave only *.tmp.<pid> strays, never a
    truncated file under the final name (io/writers.atomic_output), and
    resume sweeps the strays and reproduces the full run byte-identically
   ."""
    full = tmp_path / "full"
    part = tmp_path / "part"
    full.mkdir()
    part.mkdir()
    run(full, "numpy", subst=True)
    names = sorted(
        p for p in os.listdir(full) if p.endswith(".SIFTprediction")
    )

    # simulate the crash: one completed output, one killed mid-write
    # (atomic_output leaves the partial bytes under the tmp name only)
    (part / names[0]).write_bytes((full / names[0]).read_bytes())
    stray = part / f"{names[1]}.tmp.9999"
    stray.write_bytes((full / names[1]).read_bytes()[:17])
    # the sweep only removes strays older than its grace window (live
    # multi-host siblings' temp files must survive); age this one
    os.utime(stray, (os.path.getmtime(stray) - 3600,) * 2)
    assert not (part / names[1]).exists()

    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(part),
        align_backend="numpy",
        resume=True,
        log=open(os.devnull, "w"),
    )
    queries = run_pipeline(cfg)
    assert len(queries) == 1  # the killed query re-ran; the stray is gone
    assert not stray.exists()
    for name in names:
        assert filecmp.cmp(full / name, part / name, shallow=False), name


def test_resume_manifest_warns_on_parameter_mismatch(tmp_path):
    """--resume against an --out produced with different output-affecting
    parameters warns via the run manifest (advisor r4: resume matched on
    filename only)."""
    import io

    out = tmp_path / "out"
    out.mkdir()
    run(out, "numpy", subst=True)
    assert (out / ".sift4g_tpu_run.json").exists()

    log = io.StringIO()
    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(out),
        align_backend="numpy",
        resume=True,
        median_threshold=3.0,  # differs from the recorded 2.75
        log=log,
    )
    assert run_pipeline(cfg) == []  # everything already predicted
    assert "median_threshold" in log.getvalue()
    assert "WARNING" in log.getvalue()


def test_cli_cache_dir_flag(tmp_path, monkeypatch):
    """--cache-dir routes parse caches away from input directories."""
    import subprocess
    import sys

    monkeypatch.delenv("SIFT4G_TPU_CACHE_DIR", raising=False)
    out = tmp_path / "out"
    cache = tmp_path / "cache"
    out.mkdir()
    env = dict(os.environ)
    env.pop("SIFT4G_TPU_CACHE_DIR", None)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-m", "sift4g_tpu", "--platform", "cpu",
         "-q", os.path.join(TEST_FILES, "query.fasta"),
         "-d", os.path.join(TEST_FILES, "sample_protein_database.fa"),
         "--out", str(out), "--backend", "numpy",
         "--cache-dir", str(cache)],
        capture_output=True, timeout=300, env=env,
    )
    assert res.returncode == 0, res.stderr.decode()
    assert [f for f in os.listdir(cache) if f.endswith(".s4gc")]
    # the read-only reference tree stayed pristine
    assert not [f for f in os.listdir(TEST_FILES) if f.endswith(".s4gc")]


def test_resume_after_sigkill_midrun(tmp_path):
    """The crash-recovery scenario end to end: SIGKILL a real run once
    its first predictions land, then --resume; the union of outputs is
    byte-identical to an uninterrupted run (atomic writes guarantee every
    surviving file is complete)."""
    import signal
    import subprocess
    import sys
    import time

    rng = __import__("numpy").random.default_rng(13)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    n_q = 24
    with open(tmp_path / "q.fa", "w") as fh:
        qs = []
        for i in range(n_q):
            s = "".join(rng.choice(list(aas), int(rng.integers(80, 200))))
            qs.append(s)
            fh.write(f">Q{i}\n{s}\n")
    with open(tmp_path / "db.fa", "w") as fh:
        for i in range(600):
            fh.write(
                f">t{i}\n{''.join(rng.choice(list(aas), int(rng.integers(60, 300))))}\n"
            )
        for i, s in enumerate(qs):  # homologs so every query has output
            fh.write(f">h{i}\n{s}\n")

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["SIFT4G_TPU_CACHE_DIR"] = str(tmp_path / "cache")
    base = [
        sys.executable, "-m", "sift4g_tpu", "--platform", "cpu",
        "-q", str(tmp_path / "q.fa"), "-d", str(tmp_path / "db.fa"),
        "--backend", "numpy", "-t", "2",
    ]

    full = tmp_path / "full"
    full.mkdir()
    subprocess.run(base + ["--out", str(full)], check=True,
                   capture_output=True, timeout=600, env=env)
    names = sorted(p for p in os.listdir(full) if p.endswith(".SIFTprediction"))
    assert len(names) == n_q

    part = tmp_path / "part"
    part.mkdir()
    proc = subprocess.Popen(base + ["--out", str(part)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            done = [p for p in os.listdir(part) if p.endswith(".SIFTprediction")]
            if done:
                break
            if proc.poll() is not None:
                pytest.fail("run finished before the kill could land")
            time.sleep(0.02)
        else:
            pytest.fail("no output appeared in time")
        proc.send_signal(signal.SIGKILL)  # the crash
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    survived = sorted(p for p in os.listdir(part) if p.endswith(".SIFTprediction"))
    assert survived and len(survived) < n_q, (
        f"kill landed at an unusable point: {len(survived)}/{n_q}"
    )
    # every surviving file is COMPLETE (byte-identical to the full run's)
    for name in survived:
        assert filecmp.cmp(full / name, part / name, shallow=False), name

    res = subprocess.run(
        base + ["--out", str(part), "--resume"],
        capture_output=True, timeout=600, env=env,
    )
    assert res.returncode == 0, res.stderr.decode()
    assert b"Resume: skipping" in res.stderr
    for name in names:
        assert filecmp.cmp(full / name, part / name, shallow=False), name


def test_resume_with_device_subst_hybrid(tmp_path):
    """--resume composed with --predict-backend device + subst mode:
    the re-run subset regenerates byte-identically through the hybrid."""
    full = tmp_path / "full"
    part = tmp_path / "part"
    full.mkdir()
    part.mkdir()

    def _cfg(out, resume=False):
        return PipelineConfig(
            query_path=os.path.join(TEST_FILES, "query.fasta"),
            database_path=os.path.join(
                TEST_FILES, "sample_protein_database.fa"),
            subst_path=TEST_FILES,
            out_path=str(out),
            align_backend="numpy",
            predict_backend="device",
            resume=resume,
            log=open(os.devnull, "w"),
        )

    run_pipeline(_cfg(full))
    names = sorted(
        p for p in os.listdir(full) if p.endswith(".SIFTprediction")
    )
    assert len(names) == 2
    (part / names[0]).write_bytes((full / names[0]).read_bytes())
    queries = run_pipeline(_cfg(part, resume=True))
    assert len(queries) == 1
    for name in names:
        assert filecmp.cmp(full / name, part / name, shallow=False), name

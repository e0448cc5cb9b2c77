"""PhaseMetrics counters + the pure-Python fallback toggles."""

import io
import os
import subprocess
import sys

import numpy as np

from sift4g_tpu.utils import PhaseMetrics


def test_phase_metrics_report():
    out = io.StringIO()
    m = PhaseMetrics(log=out, enabled=True)
    with m.phase("align"):
        pass
    m.add("align", cells=2e9)
    m.phases["align"]["seconds"] = 1.0  # deterministic rate
    assert m.rate("align", "cells") == 2e9
    m.report()
    text = out.getvalue()
    assert "align" in text and "GCUPS" in text


def test_pipeline_runs_without_native(tmp_path):
    """SIFT4G_TPU_NO_NATIVE=1 must produce byte-identical predictions
    (pure-Python fallbacks vs the native engines, on a seeded database
    with planted homologs)."""
    rng = np.random.default_rng(3)
    aas = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    qs = [rng.choice(aas, 90).tobytes() for _ in range(2)]
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(150):
            fh.write(b">t%d\n%s\n" % (i, rng.choice(aas, int(rng.integers(40, 200))).tobytes()))
        for i, s in enumerate(qs):
            for k in range(6):  # mutated homologs survive the E-value filter
                h = bytearray(s)
                for p in rng.choice(len(h), 6, replace=False):
                    h[p] = int(rng.choice(aas))
                fh.write(b">h%d_%d\n%s\n" % (i, k, bytes(h)))
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))
    outs = {}
    for label, extra in (("native", {}), ("python", {"SIFT4G_TPU_NO_NATIVE": "1"})):
        out = tmp_path / label
        out.mkdir()
        env = dict(os.environ, **extra)
        code = (
            "import jax; jax.config.update('jax_platforms','cpu');"
            "from sift4g_tpu.pipeline import PipelineConfig, run_pipeline;"
            "import os;"
            "cfg=PipelineConfig("
            f"query_path={str(tmp_path / 'q.fa')!r},"
            f"database_path={str(tmp_path / 'db.fa')!r},"
            f"out_path={str(out)!r},"
            "align_backend='numpy',log=open(os.devnull,'w'));"
            "run_pipeline(cfg)"
        )
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       timeout=300)
        outs[label] = out
    names = sorted(p.name for p in outs["native"].glob("*.SIFTprediction"))
    assert names == ["q0.SIFTprediction", "q1.SIFTprediction"]
    for name in names:
        assert (outs["python"] / name).read_bytes() == \
            (outs["native"] / name).read_bytes(), name

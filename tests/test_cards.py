"""--cards device selection (reference main.cpp:254-262 getCudaCards +
database_alignment.cpp:80-86 per-card fan-out).

The digit string selects LOCAL device indices; the alignment mesh is
restricted to exactly those devices and outputs are unchanged (the mesh
partitioning never affects scores — same invariant as the thread/chunk
independence tests).  Divergence from quirk Q10 is deliberate and
documented at the CLI: no --cards here means ALL local devices, whereas
the reference's no-cards default is CPU-only.
"""

import filecmp
import os

import pytest

from sift4g_tpu.core.scorers import create_scorer
from sift4g_tpu.parallel.sharded import make_mesh

TEST_FILES = "/root/reference/test_files"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_make_mesh_cards_selects_devices():
    import jax

    mesh = make_mesh(cards=(0, 2))
    assert mesh.devices.size == 2
    picked = [d.id for d in mesh.devices.flat]
    want = [jax.local_devices()[0].id, jax.local_devices()[2].id]
    assert picked == want


def test_make_mesh_cards_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        make_mesh(cards=(0, 99))


def test_batch_aligner_honors_cards():
    from sift4g_tpu.align.batch import BatchAligner

    scorer = create_scorer("BLOSUM_62", 10, 1)
    al = BatchAligner(scorer, backend="xla", cards=(1, 3))
    assert al._mesh is not None and al._mesh.devices.size == 2
    import jax

    assert [d.id for d in al._mesh.devices.flat] == [
        jax.local_devices()[1].id,
        jax.local_devices()[3].id,
    ]
    with pytest.raises(ValueError, match="out of range"):
        BatchAligner(scorer, backend="xla", cards=(42,))


def test_cli_rejects_nondigit_cards(capsys, tmp_path):
    from sift4g_tpu.cli import main

    (tmp_path / "q.fa").write_text(">q\nMKTAYIAKQR\n")
    (tmp_path / "db.fa").write_text(">t\nMKTAYIAKQR\n")
    rc = main([
        "-q", str(tmp_path / "q.fa"),
        "-d", str(tmp_path / "db.fa"),
        "--cards", "0,2",
    ])
    assert rc == -1
    assert "invalid cards list" in capsys.readouterr().err


@pytest.mark.skipif(not os.path.isdir(TEST_FILES), reason="test files absent")
def test_cards_outputs_unchanged(tmp_path):
    """--cards 02 builds a 2-device mesh over devices {0,2}; predictions
    are byte-identical to the golden (all-device) outputs."""
    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        query_path=os.path.join(TEST_FILES, "query.fasta"),
        database_path=os.path.join(TEST_FILES, "sample_protein_database.fa"),
        subst_path=TEST_FILES,
        out_path=str(tmp_path),
        align_backend="xla",
        cards=(0, 2),
        log=open(os.devnull, "w"),
    )
    run_pipeline(cfg)
    for name in ("LACI_ECOLI", "PURR_SALTY"):
        got = tmp_path / f"{name}.SIFTprediction"
        want = os.path.join(GOLDEN, f"{name}.SIFTprediction")
        assert filecmp.cmp(got, want, shallow=False), f"{name} differs"

"""The literal scalar second oracle reproduces the frozen goldens.

tests/golden/* were generated by the framework's own
vectorized float64 path; this test re-derives the prediction files through
tests/second_oracle.py — an independent loop-for-loop transcription of the
reference C++ — and byte-compares them against the goldens.  Shared with
the production path: only the alignment records (exact-integer scores +
move paths, cross-checked by four independent backend implementations) and
the published data tables.
"""

import os

import numpy as np
import pytest

import second_oracle as so
from sift4g_tpu.core.evalue import create_evalue_params
from sift4g_tpu.core.scorers import create_scorer
from sift4g_tpu.io.fasta import read_fasta
from sift4g_tpu.io.subst import read_subst_lines, subst_file_name
from sift4g_tpu.pipeline import align_database
from sift4g_tpu.prefilter.search import search_database

TEST_FILES = "/root/reference/test_files"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TEST_FILES), reason="reference test files not mounted"
)

MEDIAN_THRESHOLD = 2.75   # main.cpp:78
SEQ_IDENTITY = 100.0      # main.cpp:80


@pytest.fixture(scope="module")
def oracle_inputs():
    """Run the shared upstream (prefilter + aligner) once; everything
    downstream is recomputed by the scalar oracle."""
    queries = read_fasta(os.path.join(TEST_FILES, "query.fasta"))
    db = os.path.join(TEST_FILES, "sample_protein_database.fa")
    devnull = open(os.devnull, "w")
    indices, cells = search_database(db, queries, log=devnull)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    params = create_evalue_params(cells, scorer)
    records = align_database(
        db, queries, indices, scorer, params,
        max_evalue=0.0001, max_alignments=400, backend="numpy", log=devnull,
    )
    return queries, records


def _oracle_predict(query, records, subst_list):
    query_letters = query.letters
    named = so.alignments_extract(query_letters, records)
    strings = [s for _, s in named]
    if strings:
        n_sel = so.alignments_select(strings, query_letters, MEDIAN_THRESHOLD)
        named = named[:n_sel]
    return so.thread_sift_predictions(
        query_letters, named, subst_list, SEQ_IDENTITY
    )


@pytest.mark.parametrize("name", ["LACI_ECOLI", "PURR_SALTY"])
def test_second_oracle_reproduces_subst_goldens(oracle_inputs, name):
    queries, records = oracle_inputs
    qi = [q.name for q in queries].index(name)
    subst_list = read_subst_lines(subst_file_name(name, TEST_FILES))
    got = _oracle_predict(queries[qi], records[qi], subst_list)
    want = open(os.path.join(GOLDEN, f"{name}.SIFTprediction"), "rb").read()
    assert got.encode("ascii") == want


@pytest.mark.parametrize("name", ["LACI_ECOLI", "PURR_SALTY"])
def test_second_oracle_reproduces_matrix_goldens(oracle_inputs, name):
    queries, records = oracle_inputs
    qi = [q.name for q in queries].index(name)
    got = _oracle_predict(queries[qi], records[qi], None)
    want = open(os.path.join(GOLDEN, f"{name}.matrix.SIFTprediction"), "rb").read()
    assert got.encode("ascii") == want


def test_scientific_tables_match_reference_header():
    """The data tables shared with the production path equal the values in
    the reference constants.hpp, parsed directly from the C++ source."""
    import re

    src = open("/root/reference/sift4g/src/constants.hpp").read()

    def parse_block(name):
        m = re.search(name + r"\s*\[[\]\[0-9]*\]\s*=\s*\{(.*?)\};", src, re.S)
        nums = re.findall(r"-?[0-9]+(?:\.[0-9]+)?(?:e-?[0-9]+)?", m.group(1))
        return np.array([float(x) for x in nums])

    rank = parse_block("rank_matrix").reshape(26, 26)
    np.testing.assert_array_equal(rank, so.RANK_MATRIX)
    np.testing.assert_allclose(parse_block("diri_q"), so.DIRI_Q, rtol=0, atol=0)
    np.testing.assert_allclose(parse_block("diri_altot"), so.DIRI_ALTOT, rtol=0, atol=0)
    np.testing.assert_allclose(
        parse_block("diri_alpha").reshape(13, 26), so.DIRI_ALPHA, rtol=0, atol=0
    )
    np.testing.assert_allclose(parse_block("aa_frequency"), so.AA_FREQUENCY, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["LACI_ECOLI", "PURR_SALTY"])
def test_second_oracle_reproduces_nw_goldens(name):
    """One non-default aligner mode (NW, global) re-derived end-to-end by
    the scalar oracle equals its frozen golden."""
    queries = read_fasta(os.path.join(TEST_FILES, "query.fasta"))
    db = os.path.join(TEST_FILES, "sample_protein_database.fa")
    devnull = open(os.devnull, "w")
    indices, cells = search_database(db, queries, log=devnull)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    params = create_evalue_params(cells, scorer)
    records = align_database(
        db, queries, indices, scorer, params,
        max_evalue=0.0001, max_alignments=400, backend="numpy",
        mode="NW", log=devnull,
    )
    qi = [q.name for q in queries].index(name)
    subst_list = read_subst_lines(subst_file_name(name, TEST_FILES))
    got = _oracle_predict(queries[qi], records[qi], subst_list)
    want = open(os.path.join(GOLDEN, f"{name}.NW.SIFTprediction"), "rb").read()
    assert got.encode("ascii") == want

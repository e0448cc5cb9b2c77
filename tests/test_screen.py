"""Device-side exact E-value screening.

The align phase's fetch at many-query scale ships (G, B) score slabs
whose padding factor is ~2.8x and whose survivor fraction is small;
screen_topk_words packs each group's E-value survivors into (G, K)
sorted words so the fetch ships only what the keep filter can use.
Exactness contract: the final per-(query, chunk) keep list — best
``max_alignments`` survivors by (score desc, database id asc) — is
IDENTICAL to the unscreened path's, including score ties across the
K boundary.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.xla import (
    SCREEN_MAX_SCORE,
    decode_screen_words,
    screen_topk_words,
)
from sift4g_tpu.core.evalue import create_evalue_params, evalues, min_passing_score
from sift4g_tpu.core.scorers import create_scorer


def _brute_topk(scores, smin, k):
    """Reference: survivors by (score desc, row asc), first k."""
    surv = [(int(s), r) for r, s in enumerate(scores) if s >= smin]
    surv.sort(key=lambda t: (-t[0], t[1]))
    return surv[:k]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_screen_words_match_bruteforce(seed):
    rng = np.random.default_rng(seed)
    G, B, k = 5, 64, 7
    scores = rng.integers(-50, 300, (G, B)).astype(np.int32)
    # force heavy ties, including across the k boundary
    scores[0, :] = 100
    scores[1, ::2] = 55
    smin = np.array([60, 55, 1, 200, 1000], dtype=np.int32)
    words = np.asarray(screen_topk_words(scores, smin, k))
    assert words.shape == (G, k)
    for g in range(G):
        rows, sc = decode_screen_words(words[g], B)
        got = list(zip(sc.tolist(), rows.tolist()))
        assert got == _brute_topk(scores[g], int(smin[g]), k), g


def test_screen_tie_preference_is_low_row():
    """Equal scores at the boundary keep the LOWEST rows (ascending
    database id within a group — the global tie order)."""
    scores = np.full((1, 32), 77, dtype=np.int32)
    words = np.asarray(screen_topk_words(scores, np.array([1], np.int32), 4))
    rows, sc = decode_screen_words(words[0], 32)
    assert rows.tolist() == [0, 1, 2, 3] and sc.tolist() == [77] * 4


def test_min_passing_score_inverts_evalues():
    """score >= min_passing_score  <=>  evalues(score) <= max_evalue,
    verified exhaustively over the integer score range."""
    scorer = create_scorer("BLOSUM_62", 10, 1)
    params = create_evalue_params(123_456_789, scorer)
    for qlen in (23, 120, 360, 2000):
        for max_ev in (1e-4, 1e-2, 10.0):
            smin = min_passing_score(max_ev, qlen, params)
            assert smin is not None and smin >= 0
            s = np.arange(0, smin + 50)
            ev = evalues(s, qlen, params)
            np.testing.assert_array_equal(ev <= max_ev, s >= smin)


def _tie_heavy_db(tmp_path, rng):
    """Database with MANY identical homolog copies: every one of them
    scores identically, so the max_alignments cut lands inside a tie run
    — the adversarial case for per-group top-k screening."""
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    q = rng.choice(aas, 80).tobytes()
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(60):
            fh.write(b">t%d\n%s\n" % (i, rng.choice(aas, 90).tobytes()))
        for i in range(40):  # identical copies -> identical scores
            fh.write(b">h%d\n%s\n" % (i, q))
    with open(tmp_path / "q.fa", "wb") as fh:
        fh.write(b">q0\n%s\n" % q)
    return str(tmp_path / "q.fa"), str(tmp_path / "db.fa")


def test_screened_align_database_exact_under_ties(tmp_path):
    """align_database with the screened device path (xla grouped, small
    groups so K < survivor count) returns the SAME records as the
    unscreened numpy oracle backend, tie run and all."""
    from sift4g_tpu.io.fasta import read_fasta
    from sift4g_tpu.pipeline import align_database
    from sift4g_tpu.prefilter.search import search_database

    rng = np.random.default_rng(41)
    qp, dbp = _tie_heavy_db(tmp_path, rng)
    queries = read_fasta(qp)
    devnull = open(os.devnull, "w")
    indices, cells = search_database(dbp, queries, log=devnull)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    params = create_evalue_params(cells, scorer)

    recs = {}
    for backend in ("numpy", "xla"):
        recs[backend] = align_database(
            dbp, queries, [ix.copy() for ix in indices], scorer, params,
            max_evalue=1e-4, max_alignments=10,   # cut INSIDE the tie run
            backend=backend, log=devnull,
        )
    a, b = recs["numpy"][0], recs["xla"][0]
    assert len(a) == 10 and len(b) == 10
    assert [(r.target_idx, r.score, round(r.evalue, 12)) for r in a] == \
           [(r.target_idx, r.score, round(r.evalue, 12)) for r in b]


def test_screen_gate_refuses_bad_thresholds():
    """Invalid thresholds (None / < 1 / overflow risk) disable screening
    but still return full exact scores."""
    from sift4g_tpu.align.batch import BatchAligner

    rng = np.random.default_rng(9)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 50).astype(np.uint8)
    targets = [rng.integers(0, 26, 70).astype(np.uint8) for _ in range(9)]
    ref = BatchAligner(scorer, backend="numpy").scores_many([(q, targets)])[0]
    al = BatchAligner(scorer, backend="xla", b_cap=32)
    al._mesh = None
    for bad in ([None], [0], [-3]):
        got = al.scores_many_async([(q, targets)], screen=(bad, 5))()[0]
        np.testing.assert_array_equal(got, ref)

"""Alignment DP tests: NumPy oracle vs brute force, and XLA scan vs oracle."""

import numpy as np
import pytest

from sift4g_tpu.align.dp_numpy import MODES, align_pair, score_pair
from sift4g_tpu.align.records import MOVE_DIAG, MOVE_LEFT, MOVE_UP
from sift4g_tpu.core.scorers import create_scorer

rng = np.random.default_rng(7)


def brute_force_score(q, t, scorer, mode):
    """O(m*n) scalar reference DP, straight from the recurrences."""
    m, n = len(q), len(t)
    go, ge = scorer.gap_open, scorer.gap_extend
    NEG = -(1 << 30)
    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    H[0, 0] = 0
    for j in range(1, n + 1):
        if mode == "NW":
            H[0, j] = -(go + (j - 1) * ge)
            E[0, j] = H[0, j]
        else:
            H[0, j] = 0
    for i in range(1, m + 1):
        if mode in ("NW", "HW"):
            H[i, 0] = -(go + (i - 1) * ge)
            F[i, 0] = H[i, 0]
        else:
            H[i, 0] = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(H[i, j - 1] - go, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go, F[i - 1, j] - ge)
            s = int(scorer.matrix[q[i - 1], t[j - 1]])
            H[i, j] = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if mode == "SW":
                H[i, j] = max(H[i, j], 0)
    if mode == "NW":
        return int(H[m, n])
    if mode == "SW":
        return int(H.max())
    if mode == "HW":
        return int(H[m, :].max())
    return int(max(H[m, :].max(), H[:, n].max()))


def random_seq(n):
    return rng.integers(0, 26, size=n).astype(np.uint8)


@pytest.mark.parametrize("mode", MODES)
def test_oracle_matches_brute_force(mode):
    scorer = create_scorer("BLOSUM_62", 10, 1)
    for _ in range(25):
        q = random_seq(int(rng.integers(1, 40)))
        t = random_seq(int(rng.integers(1, 40)))
        assert score_pair(q, t, scorer, mode) == brute_force_score(q, t, scorer, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gaps", [(10, 1), (12, 2), (11, 11)])
def test_oracle_other_gaps(mode, gaps):
    scorer = create_scorer("BLOSUM_62", *gaps)
    for _ in range(8):
        q = random_seq(int(rng.integers(1, 30)))
        t = random_seq(int(rng.integers(1, 30)))
        assert score_pair(q, t, scorer, mode) == brute_force_score(q, t, scorer, mode)


@pytest.mark.parametrize("mode", MODES)
def test_traceback_path_is_consistent(mode):
    """The traceback must replay to exactly the reported score and ends."""
    scorer = create_scorer("BLOSUM_62", 10, 1)
    for _ in range(25):
        q = random_seq(int(rng.integers(2, 50)))
        t = random_seq(int(rng.integers(2, 50)))
        rec = align_pair(q, t, scorer, mode)
        # replay the moves, scoring as we go
        score = 0
        qi, ti = rec.query_start, rec.target_start
        gap_open_q = gap_open_t = False
        for mv in rec.moves:
            if mv == MOVE_DIAG:
                score += int(scorer.matrix[q[qi], t[ti]])
                qi += 1
                ti += 1
                gap_open_q = gap_open_t = False
            elif mv == MOVE_LEFT:
                score -= scorer.gap_extend if gap_open_q else scorer.gap_open
                gap_open_q = True
                gap_open_t = False
                ti += 1
            else:
                score -= scorer.gap_extend if gap_open_t else scorer.gap_open
                gap_open_t = True
                gap_open_q = False
                qi += 1
        assert qi == rec.query_end + 1
        assert ti == rec.target_end + 1
        if mode == "SW":
            assert score == rec.score
        elif mode == "NW":
            assert rec.query_start == 0 and rec.target_start == 0
            assert rec.query_end == len(q) - 1 and rec.target_end == len(t) - 1
            assert score == rec.score
        elif mode == "HW":
            assert rec.query_start == 0 and rec.query_end == len(q) - 1
            assert score == rec.score
        else:
            assert score == rec.score


@pytest.mark.parametrize("mode", MODES)
def test_xla_scores_match_oracle(mode):
    import jax.numpy as jnp

    from sift4g_tpu.align.batch import BatchAligner

    scorer = create_scorer("BLOSUM_62", 10, 1)
    aligner = BatchAligner(scorer, mode=mode, backend="xla", b_cap=16,
                           q_bucket=16, t_bucket=32)
    q = random_seq(33)
    targets = [random_seq(int(rng.integers(1, 60))) for _ in range(23)]
    got = aligner.scores(q, targets)
    want = np.array([score_pair(q, t, scorer, mode) for t in targets])
    np.testing.assert_array_equal(got, want)

"""Native batch aligner == NumPy oracle (score, coords, moves), all modes."""

import numpy as np
import pytest

from sift4g_tpu import native
from sift4g_tpu.align.batch import align_pairs_batch
from sift4g_tpu.align.dp_numpy import align_pair
from sift4g_tpu.core.scorers import create_scorer

lib = native.load()
pytestmark = pytest.mark.skipif(lib is None, reason="native library not built")


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
@pytest.mark.parametrize("gaps", [(10, 1), (12, 2)])
def test_native_aligner_matches_oracle(mode, gaps):
    rng = np.random.default_rng(31)
    scorer = create_scorer("BLOSUM_62", *gaps)
    for trial in range(6):
        m = int(rng.integers(5, 120))
        q = rng.integers(0, 26, m).astype(np.uint8)
        targets = [
            rng.integers(0, 26, int(rng.integers(3, 200))).astype(np.uint8)
            for _ in range(7)
        ]
        # include a homologous target (mutated copy) for realistic paths
        hom = q.copy()
        hom[:: 5] = (hom[:: 5] + 1) % 26
        targets.append(hom)

        got = align_pairs_batch(q, targets, scorer, mode)
        for t, g in zip(targets, got):
            w = align_pair(q, t, scorer, mode)
            assert g.score == w.score, (mode, gaps, trial)
            assert (g.query_start, g.query_end) == (w.query_start, w.query_end)
            assert (g.target_start, g.target_end) == (w.target_start, w.target_end)
            np.testing.assert_array_equal(g.moves, w.moves)


def test_native_aligner_empty_and_tiny():
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = np.array([0, 1, 2], dtype=np.uint8)
    got = align_pairs_batch(q, [np.array([0, 1, 2], dtype=np.uint8)], scorer, "SW")
    assert got[0].score > 0
    assert align_pairs_batch(q, [], scorer, "SW") == []


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
@pytest.mark.parametrize("gaps", [(10, 1), (12, 2)])
def test_native_score_batch_matches_oracle(mode, gaps):
    """Score-only linear-memory engine (sift4g_score_batch) == oracle,
    including empty and length-1 targets, list and PackedTargets forms."""
    from sift4g_tpu.align.batch import PackedTargets, score_pairs_batch
    from sift4g_tpu.align.dp_numpy import score_pair

    rng = np.random.default_rng(53)
    scorer = create_scorer("BLOSUM_62", *gaps)
    for trial in range(4):
        m = int(rng.integers(4, 110))
        q = rng.integers(0, 26, m).astype(np.uint8)
        targets = [
            rng.integers(0, 26, int(rng.integers(0, 180))).astype(np.uint8)
            for _ in range(9)
        ]
        targets.append(np.zeros(0, dtype=np.uint8))
        targets.append(q.copy())
        want = np.array(
            [score_pair(q, t, scorer, mode) for t in targets], dtype=np.int64
        )
        got = score_pairs_batch(q, targets, scorer, mode)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {gaps} list")

        lens = np.array([t.shape[0] for t in targets], dtype=np.int32)
        starts = np.zeros(len(targets), dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        base = np.concatenate(targets) if targets else np.zeros(0, np.uint8)
        packed = PackedTargets(base, starts, lens)
        got_p = score_pairs_batch(q, packed, scorer, mode)
        np.testing.assert_array_equal(got_p, want, err_msg=f"{mode} {gaps} packed")


class _RecordingLib:
    """Delegating proxy that records the `threads` argument passed to the
    native engines (arg 9 of sift4g_align_batch, arg 10 of
    sift4g_score_batch — native/aligner.cpp:224,252)."""

    def __init__(self, real):
        self._real = real
        self.align_threads = []
        self.score_threads = []

    def __getattr__(self, name):
        real_fn = getattr(self._real, name)
        if name == "sift4g_align_batch":
            def wrapper(*args):
                self.align_threads.append(int(args[9]))
                return real_fn(*args)
            return wrapper
        if name == "sift4g_score_batch":
            def wrapper(*args):
                self.score_threads.append(int(args[10]))
                return real_fn(*args)
            return wrapper
        return real_fn


def test_configured_thread_count_reaches_native_engines(monkeypatch):
    """-t must reach traceback AND scoring (reference honors -t everywhere
    via its pool, main.cpp:188 + database_search.cpp:101-123) — and the
    outputs must not depend on it."""
    from sift4g_tpu.align.batch import BatchAligner, align_pairs_batch as apb
    import sift4g_tpu.native as native_mod

    rng = np.random.default_rng(7)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 60).astype(np.uint8)
    targets = [rng.integers(0, 26, 80).astype(np.uint8) for _ in range(5)]

    want_recs = apb(q, targets, scorer, "SW")

    rec = _RecordingLib(lib)
    monkeypatch.setattr(native_mod, "load", lambda: rec)

    got_recs = apb(q, targets, scorer, "SW", threads=3)
    assert rec.align_threads == [3]
    for w, g in zip(want_recs, got_recs):
        assert (w.score, w.query_start, w.target_end) == (
            g.score, g.query_start, g.target_end
        )
        np.testing.assert_array_equal(w.moves, g.moves)

    aligner = BatchAligner(scorer, mode="SW", backend="native", threads=2)
    got = aligner.scores(q, targets)
    assert rec.score_threads and all(t == 2 for t in rec.score_threads)
    np.testing.assert_array_equal(
        got, np.array([r.score for r in want_recs], dtype=np.int64)
    )


def test_striped_sw_matches_oracle_adversarial():
    """The AVX2 striped SW path (native/sw_simd.cpp) == NumPy oracle on
    shapes that stress the striping: query lengths around the 16-lane
    segment boundaries, tiny/empty targets, gap-heavy penalties (go==ge),
    identical sequences (dense lazy-F activity), and the int16 overflow
    gate boundary (falls back to scalar)."""
    from sift4g_tpu.align.batch import score_pairs_batch
    from sift4g_tpu.align.dp_numpy import score_pair

    rng = np.random.default_rng(99)
    for m in (1, 15, 16, 17, 31, 33, 128, 255):
        for go, ge in ((10, 1), (3, 3), (1, 1), (19, 7)):
            scorer = create_scorer("BLOSUM_62", go, ge)
            q = rng.integers(0, 26, m).astype(np.uint8)
            targets = [
                np.zeros(0, dtype=np.uint8),
                np.array([4], dtype=np.uint8),
                rng.integers(0, 26, 7).astype(np.uint8),
                rng.integers(0, 26, 200).astype(np.uint8),
                q.copy(),                      # identical: max diagonal
                np.full(64, q[0], dtype=np.uint8),  # repeat run: lazy-F heavy
            ]
            got = score_pairs_batch(q, targets, scorer, "SW")
            want = np.array(
                [score_pair(q, t, scorer, "SW") for t in targets],
                dtype=np.int64,
            )
            np.testing.assert_array_equal(got, want, err_msg=f"m={m} go={go} ge={ge}")

    # overflow-gate boundary: min(m, n) * max|sub| >= 30000 must fall back
    # to the scalar path and still be exact
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m = 2800   # 2800 * 11 = 30800 > 30000 -> scalar
    q = rng.integers(0, 26, m).astype(np.uint8)
    t = q.copy()
    got = score_pairs_batch(q, [t], scorer, "SW")
    want = score_pair(q, t, scorer, "SW")
    assert got[0] == want


def test_striped_traceback_moves_identical_adversarial():
    """The AVX2 striped-H traceback path (align_one_striped) emits
    byte-identical moves to the oracle on gappy homologs and tie-heavy
    tiny-alphabet pairs — the cases where a wrong H cell or tie order
    would diverge first."""
    rng = np.random.default_rng(97)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    for trial in range(24):
        m = int(rng.integers(10, 300))
        q = rng.integers(0, 26, m).astype(np.uint8)
        kind = trial % 3
        if kind == 0:
            t = rng.integers(0, 26, int(rng.integers(5, 400))).astype(np.uint8)
        elif kind == 1:  # homolog with indel runs
            tt = q.copy().tolist()
            for _ in range(int(rng.integers(1, 6))):
                p = int(rng.integers(0, len(tt)))
                if rng.random() < 0.5:
                    tt[p:p] = rng.integers(0, 26, int(rng.integers(1, 30))).tolist()
                else:
                    del tt[p : p + int(rng.integers(1, 20))]
            t = np.array(tt[:2000] or [0], dtype=np.uint8)
        else:  # tie-heavy: tiny alphabet
            q = rng.integers(0, 3, m).astype(np.uint8)
            t = rng.integers(0, 3, int(rng.integers(5, 400))).astype(np.uint8)
        g = align_pairs_batch(q, [t], scorer, "SW")[0]
        w = align_pair(q, t, scorer, "SW")
        assert g.score == w.score, trial
        assert (g.query_start, g.query_end, g.target_start, g.target_end) == (
            w.query_start, w.query_end, w.target_start, w.target_end), trial
        np.testing.assert_array_equal(g.moves, w.moves)

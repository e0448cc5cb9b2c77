"""Long targets and long queries run through the same GPU kernel (target
length is a loop bound, query length a strip count), interpret mode."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
from sift4g_tpu.align.xla import PAD_CODE, _extend_matrix, align_scores_kernel
from sift4g_tpu.core.scorers import create_scorer


def test_8k_query_stays_on_pallas_path():
    """An 8k-aa query routes through the grouped kernel (no XLA scan) and
    matches the NumPy oracle."""
    import sift4g_tpu.align.xla as xla_mod
    from sift4g_tpu.align.batch import BatchAligner

    rng = np.random.default_rng(11)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 8192).astype(np.uint8)
    targets = [
        rng.integers(0, 26, 40).astype(np.uint8),
        rng.integers(0, 26, 23).astype(np.uint8),
    ]
    targets.append(q[5000:5030].copy())  # a real local hit deep in the query
    ref = BatchAligner(scorer, backend="numpy").scores_many([(q, targets)])[0]

    real = xla_mod.align_scores_grouped

    def _no_scan(*a, **k):
        raise AssertionError("8k query fell back to the XLA scan")

    xla_mod.align_scores_grouped = _no_scan
    try:
        al = BatchAligner(scorer, backend="pallas", b_cap=8)
        al._mesh = None
        got = al.scores_many([(q, targets)])[0]
    finally:
        xla_mod.align_scores_grouped = real
    np.testing.assert_array_equal(got, ref)
    assert got[2] > 100


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_long_kernel_matches_xla(mode):
    """Targets across many columns (the column loop runs to each block's
    longest target; shorter lanes are masked past their length)."""
    rng = np.random.default_rng(29)
    G, B, N, m_pad = 2, 8, 1024, 64
    qlens = np.array([37, 21], dtype=np.int32)
    q_all = np.full(G * m_pad, PAD_CODE, dtype=np.int32)
    q_off = (np.arange(G) * m_pad).astype(np.int32)
    for g in range(G):
        q_all[g * m_pad : g * m_pad + qlens[g]] = rng.integers(0, 26, qlens[g])
    targets = np.full((G, B, N), PAD_CODE, dtype=np.int32)
    lens = rng.integers(600, N + 1, size=(G, B)).astype(np.int32)
    lens[0, 0] = N      # exactly full
    lens[0, 1] = 1
    lens[1, :] = rng.integers(1, 300, size=B)  # a block far below its rung
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])

    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = _extend_matrix(scorer.matrix)
    got = np.asarray(
        sw_scores_pallas_grouped(q_all, q_off, qlens, targets, lens, m32, mode=mode)
    )
    for g in range(G):
        ref = np.asarray(
            align_scores_kernel(
                q_all[g * m_pad : (g + 1) * m_pad],
                np.int32(qlens[g]),
                targets[g],
                lens[g],
                m32,
                mode=mode,
            )
        )
        np.testing.assert_array_equal(got[g], ref, err_msg=f"group {g} mode {mode}")

"""Grouped GPU kernel == NumPy oracle (interpret mode): strip boundaries,
padding lanes, uninitialized tails and the kernel's tuning variants."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.dp_numpy import score_pair
from sift4g_tpu.align.pallas_sw import ROWS, sw_scores_pallas_grouped
from sift4g_tpu.align.xla import PAD_CODE, _extend_matrix
from sift4g_tpu.core.scorers import create_scorer


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_grouped_matches_xla(mode):
    rng = np.random.default_rng(13)
    # B=12 is no power of two: the wrapper pads lanes to the program block
    G, B, N, m_pad = 3, 12, 128, 2 * ROWS
    # lengths around the register strip: a full strip plus 3 single rows,
    # a query shorter than one strip, and exactly two strips
    qlens = np.array([ROWS + 3, 5, 2 * ROWS], dtype=np.int32)
    q_all = np.full(G * m_pad, PAD_CODE, dtype=np.int32)
    q_offsets = (np.arange(G) * m_pad).astype(np.int32)
    for g in range(G):
        q_all[g * m_pad : g * m_pad + qlens[g]] = rng.integers(0, 26, qlens[g])
    # uninitialized tails: arbitrary int8 bytes past every target's length
    targets = rng.integers(-128, 128, size=(G, B, N)).astype(np.int8)
    lens = rng.integers(1, N + 1, size=(G, B)).astype(np.int32)
    lens[0, 0] = N
    lens[1, 1] = 1
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])

    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = _extend_matrix(scorer.matrix)
    kw = dict(mode=mode)
    got = np.asarray(
        sw_scores_pallas_grouped(q_all, q_offsets, qlens, targets, lens, m32, **kw)
    )
    # tuning variants are bit-identical: one-row strips, 4-row strips,
    # and 8-lane programs (several programs per group)
    for variant in (dict(rows=1), dict(rows=4), dict(block=8, num_warps=1)):
        np.testing.assert_array_equal(
            np.asarray(sw_scores_pallas_grouped(
                q_all, q_offsets, qlens, targets, lens, m32, **kw, **variant
            )),
            got, err_msg=str(variant),
        )
    for g in range(G):
        q = q_all[g * m_pad : g * m_pad + qlens[g]].astype(np.uint8)
        want = [
            score_pair(q, targets[g, b, : lens[g, b]].astype(np.uint8), scorer, mode)
            for b in range(B)
        ]
        np.testing.assert_array_equal(got[g], want, err_msg=f"group {g} mode {mode}")

"""Batched affine-gap alignment scores on device (JAX/XLA).

One query vs a padded batch of targets, all four modes (SW/NW/HW/OV —
reference main.cpp:51-56), as a plain ``lax.scan`` over query rows:

* each row's substitution scores are looked up inside the scan from the
  query profile ``matrix32[q[i]]`` by target code, giving (B, N) per row —
  no (m x B x N) score tensor is ever built;
* the in-row serial dependency of the affine E term is eliminated with the
  decayed-prefix-max identity
  ``E[i,j] = max_{k<j}(H[i,k] + k*ge) - go - (j-1)*ge``
  (valid because ge <= go), computed with ``jax.lax.cummax``;
* query length is padded to a bucket; the true end row is captured inside
  the scan with a ``where`` on the row counter, so one compiled program
  serves a whole (m_bucket, N_bucket) shape class.

The row scan is the semantic twin of the NumPy oracle in dp_numpy.py; a
property test asserts exact score equality.  It is the portable plain
version of the grouped GPU kernel (pallas_sw.py): the CPU oracle for the
launch policy and the mesh tests, and the XLA baseline the kernel is
timed against.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 28)
PAD_CODE = 31


def _extend_matrix(matrix: np.ndarray) -> np.ndarray:
    """26x26 -> 32x32 with NEG rows/cols for padding codes."""
    m32 = np.full((32, 32), NEG, dtype=np.int32)
    m32[:26, :26] = matrix
    return m32


def align_scores(
    query_codes: jnp.ndarray,   # (m_pad,) int32, PAD_CODE beyond m
    query_len: jnp.ndarray,     # () int32
    targets: jnp.ndarray,       # (B, N) int32, PAD_CODE beyond lengths
    target_lens: jnp.ndarray,   # (B,) int32
    matrix32: jnp.ndarray,      # (32, 32) int32 (NEG-padded)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> jnp.ndarray:
    """Alignment scores (B,) int32 of one query vs B targets.

    Unjitted core — usable inside ``jax.shard_map`` (parallel/sharded.py)
    and under ``jax.jit`` via :data:`align_scores_kernel`.
    """
    m_pad = query_codes.shape[0]
    B, N = targets.shape
    go, ge = gap_open, gap_extend

    # query profile: prof[i, c] = matrix32[q[i], c]; row i's scores are
    # prof[i][t] inside the scan.  Codes are masked to 5 bits so garbage
    # tails past a target's length stay in range (those columns never
    # reach an extracted score)
    prof = matrix32.astype(jnp.int32)[query_codes.astype(jnp.int32)]  # (m, 32)
    tcodes = targets.astype(jnp.int32) & 31

    js = jnp.arange(1, N + 1, dtype=jnp.int32)
    j_ge = jnp.arange(0, N + 1, dtype=jnp.int32) * ge
    col_pad_mask = js[None, :] <= target_lens[:, None]               # (B, N)

    free_top = mode in ("SW", "HW", "OV")
    free_left = mode in ("SW", "OV")
    local = mode == "SW"

    # row 0 boundary
    if free_top:
        H0 = jnp.zeros((B, N + 1), dtype=jnp.int32)
    else:  # NW
        H0 = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             jnp.broadcast_to(-(go + (js - 1) * ge)[None, :], (B, N))], axis=1)
    F0 = jnp.full((B, N + 1), NEG, dtype=jnp.int32)

    def row_step(carry, xs):
        Hprev, Fprev, best_sw, last_col_best, final_row = carry
        prof_row, i1 = xs
        s_row = prof_row[tcodes]  # (B, N) scores of row i1 (1-based)

        if free_left:
            h_left0 = jnp.zeros((B, 1), dtype=jnp.int32)
        else:
            h_left0 = jnp.full((B, 1), -(go + (i1 - 1) * ge), dtype=jnp.int32)

        F = jnp.maximum(Hprev[:, 1:] - go, Fprev[:, 1:] - ge)        # (B, N)
        diag = Hprev[:, :-1] + s_row
        G = jnp.maximum(diag, F)
        if local:
            G = jnp.maximum(G, 0)
        X = jnp.concatenate([h_left0, G], axis=1)                    # (B, N+1)
        P = jax.lax.cummax(X + j_ge[None, :], axis=1)
        E = P[:, :-1] - go - (js - 1)[None, :] * ge
        Hrow = jnp.maximum(G, E)
        H = jnp.concatenate([h_left0, Hrow], axis=1)
        Ffull = jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32), F], axis=1)

        in_range = i1 <= query_len
        if local:
            row_best = jnp.max(jnp.where(col_pad_mask, Hrow, NEG), axis=1)
            best_sw = jnp.where(in_range, jnp.maximum(best_sw, row_best), best_sw)
        if mode == "OV":
            at_n = jnp.take_along_axis(H, target_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
            last_col_best = jnp.where(in_range, jnp.maximum(last_col_best, at_n), last_col_best)
        final_row = jnp.where(i1 == query_len, H, final_row)
        return (H, Ffull, best_sw, last_col_best, final_row), None

    # OV: the boundary cell H[0, n_b] = 0 competes for the last-column best.
    last_col_init = (
        jnp.zeros((B,), dtype=jnp.int32) if mode == "OV"
        else jnp.full((B,), NEG, dtype=jnp.int32)
    )
    init = (
        H0,
        F0,
        jnp.zeros((B,), dtype=jnp.int32),
        last_col_init,
        H0,
    )
    i1s = jnp.arange(1, m_pad + 1, dtype=jnp.int32)
    (_, _, best_sw, last_col_best, final_row), _ = jax.lax.scan(
        row_step, init, (prof, i1s)
    )

    if mode == "SW":
        return best_sw
    at_n = jnp.take_along_axis(final_row, target_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
    if mode == "NW":
        return at_n
    row_masked = jnp.where(col_pad_mask, final_row[:, 1:], NEG)
    last_row_best = jnp.max(row_masked, axis=1)
    # j = 0 cell of the final row also competes when targets may be skipped
    last_row_best = jnp.maximum(last_row_best, final_row[:, 0])
    if mode == "HW":
        return last_row_best
    return jnp.maximum(last_row_best, last_col_best)  # OV


align_scores_kernel = partial(
    jax.jit, static_argnames=("mode", "gap_open", "gap_extend")
)(align_scores)


def align_scores_grouped(
    q_codes_all: jnp.ndarray,   # (Qm,) int32 concatenated padded queries
    q_offsets: jnp.ndarray,     # (G,) int32
    q_lens: jnp.ndarray,        # (G,) int32
    targets: jnp.ndarray,       # (G, B, N) int8/int32 codes
    target_lens: jnp.ndarray,   # (G, B) int32
    matrix32: jnp.ndarray,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    m_window: int = 0,
) -> jnp.ndarray:
    """Portable twin of ``sw_scores_pallas_grouped``: same signature and
    exact integer scores, built on the XLA row scan.  Safe with
    uninitialized target tails: columns past a target's length never
    influence extracted scores (left-to-right DP + length-masked
    extraction).

    ``m_window`` (static) bounds the per-group row scan: the launch's
    ladder-bucketed max query length (every q_lens[g] must be <= m_window).
    0 scans the whole concatenated buffer."""

    def one_group(off, qlen, t, tl):
        # bring this group's query to the front; rows past qlen are inert
        q = jnp.roll(q_codes_all, -off)
        if m_window and m_window < q.shape[0]:
            q = q[:m_window]
        return align_scores(
            q, qlen, t.astype(jnp.int32), tl, matrix32,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )

    return jax.vmap(one_group)(
        q_offsets.astype(jnp.int32), q_lens.astype(jnp.int32),
        targets, target_lens.astype(jnp.int32),
    )


align_scores_grouped_kernel = partial(
    jax.jit, static_argnames=("mode", "gap_open", "gap_extend", "m_window")
)(align_scores_grouped)


SCREEN_ROW_BITS = 12          # batch width <= 4096 rows per group
SCREEN_ROW_MASK = (1 << SCREEN_ROW_BITS) - 1
# score * 4096 must stay inside int32: survivors' scores are bounded by
# max_qlen * max_sub; callers gate screening on this
SCREEN_MAX_SCORE = (1 << (31 - SCREEN_ROW_BITS)) - 1


def screen_topk_words(scores: jnp.ndarray, smin: jnp.ndarray, k: int) -> jnp.ndarray:
    """Device-side exact E-value screening.

    Packs each group's E-value survivors (``score >= smin[g]``, the
    integer threshold from core.evalue.min_passing_score) into int32
    words ``score * 4096 + (B-1-row)`` and returns the ``k`` largest per
    group, descending; losers/padding are -1.  The fetch then ships
    (G, k) words instead of (G, B) scores.

    Exactness: the final per-query selection keeps the best
    ``max_alignments`` survivors by (score desc, id asc).  Rows within a
    group are ascending in database id (the bucketing is stable), so the
    word order (score desc, row asc via the inverted row encoding) equals
    the global tie order restricted to the group; any candidate outside
    its group's top-k is dominated by k in-group candidates and can never
    reach the global top-``max_alignments`` for k >= max_alignments.
    Mirrors the E-value filter inside swsharp's alignDatabase
    (reference database_alignment.cpp:83-86,129-134).
    """
    G, B = scores.shape
    # the row field is SCREEN_ROW_BITS wide; the launch policy's 4096
    # width clamp keeps B inside it, so enforce the coupling loudly here
    assert B <= SCREEN_ROW_MASK + 1, f"batch width {B} overflows the row field"
    rowenc = (B - 1) - jax.lax.broadcasted_iota(jnp.int32, (G, B), 1)
    words = jnp.where(
        scores >= smin[:, None],
        scores * (SCREEN_ROW_MASK + 1) + rowenc,
        jnp.int32(-1),
    )
    return -jnp.sort(-words, axis=1)[:, :k]


def decode_screen_words(words: np.ndarray, batch_width: int):
    """Host inverse of screen_topk_words for ONE group: (rows, scores)
    of the survivors, best-first."""
    w = words[words >= 0]
    rows = (batch_width - 1) - (w & SCREEN_ROW_MASK)
    return rows, w >> SCREEN_ROW_BITS


def align_scores_grouped_resident(
    q_codes_all: jnp.ndarray,   # (Qm,) int32 concatenated padded queries
    q_offsets: jnp.ndarray,     # (G,) int32
    q_lens: jnp.ndarray,        # (G,) int32
    db_flat: jnp.ndarray,       # (R,) uint8 resident codes
    t_starts: jnp.ndarray,      # (G, B) int32 element offsets into db_flat
    target_lens: jnp.ndarray,   # (G, B) int32
    matrix32: jnp.ndarray,      # (32, 32) int32
    n_pad: int = 512,           # static bound on target lengths (the rung)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    m_window: int = 0,
) -> jnp.ndarray:
    """Portable twin of ``sw_scores_pallas_grouped_resident``: gathers each
    (group, row) target from the resident flat array (only the bytes
    inside its length; PAD_CODE past it), then scores through the exact
    grouped XLA twin."""
    cols = jnp.arange(n_pad, dtype=jnp.int32)
    valid = cols[None, None, :] < target_lens.astype(jnp.int32)[:, :, None]
    idx = jnp.where(valid, t_starts.astype(jnp.int32)[:, :, None] + cols, 0)
    tg = jnp.where(valid, db_flat[idx].astype(jnp.int32), PAD_CODE)
    return align_scores_grouped(
        q_codes_all, q_offsets, q_lens, tg, target_lens, matrix32,
        mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        m_window=m_window,
    )

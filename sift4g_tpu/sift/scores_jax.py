"""SIFT scoring math as jit-able JAX array ops (device variant).

Functional mirror of the float64 NumPy oracle in scores.py (which remains
the bit-parity path for file output — reference sift_scores.cpp computes
in double).  This variant exists for on-device batched scoring: one-hot
contractions and elementwise ops that XLA fuses, vmapped over queries
padded to a common length.

Numerics: float32; agreement with the float64 oracle is asserted to ~1e-4
relative in tests (adequate for 4-decimal SIFT scores; the file writers
keep using the oracle).  Every contraction pins ``HIGHEST`` precision: a
GPU may otherwise run float32 matmuls in TF32 (~3 decimal digits), far
looser than the ~1e-5 agreement the subst screen relies on
(predict_subst.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


from ..constants import DIRI_ALPHA, DIRI_ALTOT, DIRI_Q, RANK_MATRIX, VALID_AA_MASK

X_CODE = ord("X") - ord("A")
HIGHEST = jax.lax.Precision.HIGHEST


def _onehot_valid(rows: jnp.ndarray) -> jnp.ndarray:
    """(n, L) codes -> (n, L, 26) one-hot over valid amino acids only."""
    oh = jax.nn.one_hot(rows, 26, dtype=jnp.float32)
    valid = jnp.asarray(VALID_AA_MASK, jnp.float32)
    return oh * valid[None, None, :]


def create_matrix(rows: jnp.ndarray, weights: jnp.ndarray):
    """Weighted count matrix (createMatrix, sift_scores.cpp:555-570).

    rows (n, L) int; weights (n,) -> (matrix (L, 26), tot (L,)).
    """
    oh = _onehot_valid(rows)
    matrix = jnp.einsum("s,sla->la", weights.astype(jnp.float32), oh,
                        precision=HIGHEST)
    return matrix, matrix.sum(axis=1)


def calc_seq_weights(rows: jnp.ndarray, raw_matrix: jnp.ndarray, n_valid=None):
    """Henikoff position-based weights (calcSeqWeights, :453-498).

    ``n_valid`` is the number of REAL sequence rows; padding rows (all-'X',
    used by the batched path to give every query the same row count) earn
    zero weight on their own, but the reference normalizes weights to sum
    to the sequence count, so the count must exclude padding."""
    n, L = rows.shape
    valid = jnp.asarray(VALID_AA_MASK, jnp.bool_)
    ndiff = ((raw_matrix > 0.0) & valid[None, :]).sum(axis=1).astype(jnp.float32)
    oh = _onehot_valid(rows)                                   # (n, L, 26)
    counts_at = jnp.einsum("sla,la->sl", oh, raw_matrix,
                           precision=HIGHEST)                  # raw[l, rows[s,l]]
    ok = (counts_at > 0.0)
    denom = jnp.where(ok, ndiff[None, :] * counts_at, 1.0)
    w = jnp.where(ok, 1.0 / denom, 0.0).sum(axis=1)
    tot = w.sum()
    n_eff = n if n_valid is None else n_valid
    return jnp.where(tot != 0, w / tot * n_eff, w), ndiff


def calc_epsilon(weighted: jnp.ndarray, max_aa_onehot: jnp.ndarray, ndiff: jnp.ndarray):
    """Rank-based pseudocount scale (calcEpsilon, :60-86).

    max_aa_onehot: (L, 26) one-hot of the per-position max aa (avoids the
    RANK_MATRIX row gather).
    """
    ranks = jnp.matmul(max_aa_onehot, jnp.asarray(RANK_MATRIX, jnp.float32),
                       precision=HIGHEST)                          # (L, 26)
    validf = jnp.asarray(VALID_AA_MASK, jnp.float32)
    wv = weighted * validf[None, :]
    num = (ranks * wv).sum(axis=1)
    den = wv.sum(axis=1)
    eps = jnp.exp(num / jnp.where(den == 0, 1.0, den))
    return jnp.where(ndiff == 1, 0.0, eps)


def calc_diri(weighted: jnp.ndarray) -> jnp.ndarray:
    """13-component Dirichlet-mixture regularizer (calcDiri, :379-451)."""
    gammaln = jax.scipy.special.gammaln
    validf = jnp.asarray(VALID_AA_MASK, jnp.float32)
    alpha = jnp.asarray(DIRI_ALPHA, jnp.float32)       # (13, 26)
    altot = jnp.asarray(DIRI_ALTOT, jnp.float32)       # (13,)
    logq = jnp.log(jnp.asarray(DIRI_Q, jnp.float32))   # (13,)

    wv = weighted * validf[None, :]                    # (L, 26)
    tot = wv.sum(axis=1)                               # (L,)
    probn = (
        gammaln(tot + 1.0)[None, :]
        + gammaln(altot)[:, None]
        - gammaln(tot[None, :] + altot[:, None])
    )                                                  # (13, L)
    # per-aa terms over valid letters; alpha is sanitized to 1.0 at invalid
    # letters first — gammaln(0) = inf would otherwise turn inf * mask0
    # into NaN
    alpha_safe = jnp.where(validf[None, :] > 0, alpha, 1.0)
    term = (
        gammaln(wv[None, :, :] + alpha_safe[:, None, :])
        - gammaln(wv + 1.0)[None, :, :]
        - gammaln(alpha_safe)[:, None, :]
    )                                                  # (13, L, 26)
    probn = probn + (term * validf[None, None, :]).sum(axis=2)
    denom = jax.scipy.special.logsumexp(logq[:, None] + probn, axis=0)  # (L,)
    probj = jnp.exp(logq[:, None] + probn - denom[None, :])             # (13, L)
    diric = jnp.einsum("jl,ja->la", probj, alpha,
                       precision=HIGHEST) * validf[None, :]
    totreg = diric.sum(axis=1)
    return diric / jnp.where(totreg == 0, 1.0, totreg)[:, None]


def calc_sift_scores(rows: jnp.ndarray, raw_matrix: jnp.ndarray, n_valid=None):
    """calcSIFTScores (:324-377): rows include the query as row 0.

    Returns (SIFTscores (L, 26), seq_weights (n,), ndiff (L,)).
    """
    seq_weights, ndiff = calc_seq_weights(rows, raw_matrix, n_valid)
    weighted, tot_weights = create_matrix(rows, seq_weights)
    max_oh = jax.nn.one_hot(jnp.argmax(weighted, axis=1), 26, dtype=jnp.float32)
    eps = calc_epsilon(weighted, max_oh, ndiff)
    diric = calc_diri(weighted)
    sift = (weighted + eps[:, None] * diric) / (tot_weights + eps)[:, None]
    row_max = jnp.max(sift, axis=1)
    sift = sift / jnp.where(row_max == 0, 1.0, row_max)[:, None]
    return sift, seq_weights, ndiff


calc_sift_scores_jit = jax.jit(calc_sift_scores)

# Batched over queries: rows (Q, n, L) with per-query padding rows of 'X'
# (masked as invalid), raw (Q, L, 26).
calc_sift_scores_batch = jax.jit(jax.vmap(calc_sift_scores))


def sift_scores_from_rows(rows: jnp.ndarray, n_valid: jnp.ndarray) -> jnp.ndarray:
    """One query: rows (n_pad, L_pad) int codes ('X' both as row padding and
    position padding), n_valid real rows -> SIFT scores (L_pad, 26)."""
    raw, _ = create_matrix(rows, jnp.ones(rows.shape[0], jnp.float32))
    sift, _, _ = calc_sift_scores(rows, raw, n_valid)
    return sift


# The batched full-matrix prediction entry: (Q, n_pad, L_pad) + (Q,) ->
# (Q, L_pad, 26).  jit per (n_pad, L_pad) bucket shape.
sift_scores_from_rows_batch = jax.jit(jax.vmap(sift_scores_from_rows))

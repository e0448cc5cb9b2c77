"""Pallas (Triton route) GPU kernel: grouped affine-gap alignment scores.

The hot op of the pipeline.  The reference runs this DP in swsharp's CUDA
kernels (database_alignment.cpp:83-86); the design here follows the same
inter-sequence idea — one lane per database target:

* a program owns one group (one query) and ``block`` targets, one lane
  each, and sweeps the target columns j in a loop whose bound is the
  longest target of the block (target length is a loop bound, not a
  buffer budget — long targets and long queries use the same kernel);
* the query is processed in strips of ``rows`` rows held per lane in
  registers: H and E of every strip row are loop carries along j, F flows
  serially down the unrolled rows of one column;
* only a strip's bottom row (H and F per column) is stored, in a
  per-program (n_cap, block) scratch that the next strip reads back;
* substitution scores come from the query profile ``matrix[q[i], :]``
  looked up by the lanes' target codes (no per-cell score tensor).

Targets are read by element offset from a flat code array: the grouped
slab ``(G, B, N)`` flattened, or the device-resident database
(batch.ResidentDB).  Columns past a lane's length read code PAD_CODE,
whose substitution score is NEG, so they never raise a result.  Query
rows past a strip multiple run as single-row strips, so every processed
row is a real row and the last strip's bottom row is the query's last
row.

Scores are exact int32 — bit-identical to the NumPy oracle (dp_numpy.py)
and the XLA scan (xla.py).  E uses the textbook recurrence
``E[i,j] = max(H[i,j-1] - go, E[i,j-1] - ge)``, which equals the oracle's
decayed-prefix-max form whenever ge <= go (the scorer enforces it).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

NEG = -(1 << 28)
PAD_CODE = 31

ROWS = 32       # query rows per register strip (H100 sweep: PERF.md)
BLOCK = 128     # target lanes per program (power of two)
NUM_WARPS = 4


def interpret_default() -> bool:
    """Interpret the kernel exactly when JAX runs on the CPU (tests); on a
    GPU the kernel is always compiled."""
    return jax.default_backend() == "cpu"


def _kernel(prof_ref, qoff_ref, qlen_ref, flat_ref, start_ref, len_ref,
            out_ref, sh_ref, sf_ref, *, mode, go, ge, rows, block, n_cap):
    g = pl.program_id(0)
    prog = g * pl.num_programs(1) + pl.program_id(1)
    lane0 = prog * block
    starts = start_ref[pl.ds(lane0, block)]
    lens = len_ref[pl.ds(lane0, block)]
    qoff = qoff_ref[g]
    qlen = qlen_ref[g]
    ncol = jnp.minimum(jnp.max(lens), n_cap)
    sbase = prog * (n_cap * block)

    local = mode == "SW"
    free_top = mode != "NW"
    free_left = mode in ("SW", "OV")
    negv = jnp.full((block,), NEG, jnp.int32)

    def left_h(i):
        """H[i, 0] of DP row i (traced scalar)."""
        if free_left:
            return jnp.int32(0)
        # -(go + (i-1) ge) for i >= 1, 0 for i = 0 (arithmetic: Triton
        # refuses this scalar select)
        return -(go + (i - 1) * ge) * jnp.minimum(i, 1)

    def col_slice(j):
        return pl.ds(sbase + j * block, block)

    # row 0 boundary into the bottom-row scratch
    def init_col(j, c):
        if free_top:
            sh_ref[col_slice(j)] = jnp.zeros((block,), jnp.int32)
        else:
            sh_ref[col_slice(j)] = jnp.full((block,), -(go + j * ge), jnp.int32)
        sf_ref[col_slice(j)] = negv
        return c

    jax.lax.fori_loop(0, ncol, init_col, 0)

    def strip(row0, nrows, acc):
        """DP rows row0+1 .. row0+nrows over every column of the block."""
        best, lastcol, _, _ = acc
        hprev = tuple(
            jnp.full((block,), left_h(row0 + r + 1), jnp.int32)
            for r in range(nrows)
        )
        e0 = tuple(negv for _ in range(nrows))
        d0 = jnp.full((block,), left_h(row0), jnp.int32)
        pbase = [(qoff + row0 + r) * 32 for r in range(nrows)]
        # last-row extraction restarts every strip; the final strip's
        # bottom row is DP row qlen
        bottom0 = hprev[-1]

        def col(j, c):
            hprev, e, d0, best, lastcol, rowbest, nwval = c
            valid = j < lens
            code = flat_ref[jnp.where(valid, starts + j, 0)].astype(jnp.int32)
            code = jnp.where(valid, code, PAD_CODE)
            hup = sh_ref[col_slice(j)]
            fup = sf_ref[col_slice(j)]
            diag = d0
            d0_next = hup
            newh, newe = [], []
            colmax = None
            for r in range(nrows):
                s = prof_ref[pbase[r] + code]
                er = jnp.maximum(hprev[r] - go, e[r] - ge)
                f = jnp.maximum(hup - go, fup - ge)
                h = jnp.maximum(jnp.maximum(diag + s, er), f)
                if local:
                    h = jnp.maximum(h, 0)
                    best = jnp.maximum(best, h)
                if mode == "OV":
                    colmax = h if colmax is None else jnp.maximum(colmax, h)
                diag = hprev[r]
                newh.append(h)
                newe.append(er)
                hup, fup = h, f
            sh_ref[col_slice(j)] = hup
            sf_ref[col_slice(j)] = fup
            at_end = j == lens - 1
            if mode == "OV":
                lastcol = jnp.where(at_end, jnp.maximum(lastcol, colmax), lastcol)
            if mode in ("HW", "OV"):
                rowbest = jnp.maximum(rowbest, jnp.where(valid, hup, NEG))
            if mode == "NW":
                nwval = jnp.where(at_end, hup, nwval)
            return (tuple(newh), tuple(newe), d0_next, best, lastcol,
                    rowbest, nwval)

        c = jax.lax.fori_loop(
            0, ncol, col, (hprev, e0, d0, best, lastcol, bottom0, bottom0)
        )
        return c[3:]

    zero = jnp.zeros((block,), jnp.int32)
    # SW best floor 0; OV's last column starts at H[0, n] = 0
    acc = (zero, zero, negv, negv)
    n_full = qlen // rows
    acc = jax.lax.fori_loop(
        0, n_full, lambda s, a: strip(s * rows, rows, a), acc
    )
    if rows > 1:
        acc = jax.lax.fori_loop(
            n_full * rows, qlen, lambda i, a: strip(i, 1, a), acc
        )
    best, lastcol, rowbest, nwval = acc
    if mode == "SW":
        res = best
    elif mode == "NW":
        res = nwval
    elif mode == "HW":
        res = rowbest
    else:
        res = jnp.maximum(rowbest, lastcol)
    out_ref[pl.ds(lane0, block)] = res


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@partial(
    jax.jit,
    static_argnames=("n_cap", "mode", "gap_open", "gap_extend", "rows",
                     "block", "num_warps", "interpret"),
)
def _grouped_offsets(q_codes_all, q_offsets, q_lens, flat, t_starts,
                     target_lens, matrix32, *, n_cap, mode, gap_open,
                     gap_extend, rows, block, num_warps, interpret):
    G, B = t_starts.shape
    bt = min(block, _pow2_at_least(B))
    bp = -(-B // bt) * bt
    starts = jnp.zeros((G, bp), jnp.int32).at[:, :B].set(t_starts.astype(jnp.int32))
    lens = jnp.zeros((G, bp), jnp.int32).at[:, :B].set(target_lens.astype(jnp.int32))
    nblk = bp // bt
    n_scratch = G * nblk * n_cap * bt
    assert n_scratch < 2**31, "launch too large for int32 scratch offsets"
    # query profile: prof[i, c] = matrix32[q[i], c]
    prof = matrix32.astype(jnp.int32)[q_codes_all.astype(jnp.int32)].reshape(-1)
    out, _, _ = pl.pallas_call(
        partial(_kernel, mode=mode, go=gap_open, ge=gap_extend, rows=rows,
                block=bt, n_cap=n_cap),
        out_shape=(
            jax.ShapeDtypeStruct((G * bp,), jnp.int32),
            jax.ShapeDtypeStruct((n_scratch,), jnp.int32),
            jax.ShapeDtypeStruct((n_scratch,), jnp.int32),
        ),
        grid=(G, nblk),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="sw_grouped",
    )(prof, q_offsets.astype(jnp.int32), q_lens.astype(jnp.int32), flat,
      starts.reshape(-1), lens.reshape(-1))
    return out.reshape(G, bp)[:, :B]


def sw_scores_pallas_grouped(
    q_codes_all: jnp.ndarray,   # (Qm,) int32 concatenated padded queries
    q_offsets: jnp.ndarray,     # (G,) int32
    q_lens: jnp.ndarray,        # (G,) int32
    targets: jnp.ndarray,       # (G, B, N) int8 codes; tails past a
                                # target's length are never read
    target_lens: jnp.ndarray,   # (G, B) int32
    matrix32: jnp.ndarray,      # (32, 32) int32 (NEG-padded)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    rows: int = ROWS,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
    interpret: bool | None = None,
) -> jnp.ndarray:
    """Scores (G, B) int32: group g = query g vs its B padded targets."""
    G, B, N = targets.shape
    starts = (jnp.arange(G * B, dtype=jnp.int32) * N).reshape(G, B)
    return _grouped_offsets(
        q_codes_all, q_offsets, q_lens, targets.astype(jnp.int8).reshape(-1),
        starts, target_lens, matrix32, n_cap=N, mode=mode, gap_open=gap_open,
        gap_extend=gap_extend, rows=rows, block=block, num_warps=num_warps,
        interpret=interpret_default() if interpret is None else interpret,
    )


def sw_scores_pallas_grouped_resident(
    q_codes_all: jnp.ndarray,   # (Qm,) int32 concatenated padded queries
    q_offsets: jnp.ndarray,     # (G,) int32
    q_lens: jnp.ndarray,        # (G,) int32
    db_flat: jnp.ndarray,       # (R,) uint8 device-resident database codes
    t_starts: jnp.ndarray,      # (G, B) int32 element offsets into db_flat
    target_lens: jnp.ndarray,   # (G, B) int32
    matrix32: jnp.ndarray,      # (32, 32) int32
    n_pad: int = 512,           # static bound on target lengths (the rung)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    rows: int = ROWS,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
    interpret: bool | None = None,
) -> jnp.ndarray:
    """Scores (G, B) int32 against the device-resident database: the same
    kernel, reading each target at its offset in ``db_flat`` (only the
    bytes inside a target's length are read)."""
    return _grouped_offsets(
        q_codes_all, q_offsets, q_lens, db_flat, t_starts, target_lens,
        matrix32, n_cap=n_pad, mode=mode, gap_open=gap_open,
        gap_extend=gap_extend, rows=rows, block=block, num_warps=num_warps,
        interpret=interpret_default() if interpret is None else interpret,
    )

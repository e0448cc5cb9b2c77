"""Device-batched SIFT prediction (the 20k-query mode).

The reference runs one host thread per query (sift_prediction.cpp:152-162);
at proteome scale (tens of thousands of queries) the per-query float64
host oracle costs ~16 ms each, minutes serially.  This path packs
queries into (Q, n_pad, L_pad) code tensors bucketed by padded query
length and runs the vmapped JAX scoring math (scores_jax.py) — one
device launch scores a whole bucket chunk.

Numerics: float32 on device.  Agreement with the float64 oracle is ~1e-5
on the [0, 1] scores (property-tested); the printed 4-decimal matrix can
therefore differ in the last digit on rare rounding-boundary values, so
this path is OPT-IN (--predict-backend device) and the bit-parity host
oracle remains the default.  Substitution-mode queries (.subst present)
use the device scores only as a SCREEN: per-query finishers
(predict_subst.py, via the ``finishers`` hook) re-derive every printed
or threshold-adjacent value exactly in float64, so their output files
stay byte-identical to the host oracle's.

Padding semantics: 'X' is an invalid amino acid (valid_amino_acid,
sift_scores.cpp:316-322), so padded positions and padded all-'X' rows
contribute nothing to count matrices or weights; the real row count is
passed separately for the Henikoff weight normalization
(sift_scores.cpp:493-497 normalizes weights to sum to the sequence count).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.chain import Chain
from ..utils import env_int as _env_int
from ..io.writers import create_file_name, write_matrix_original_format

X_CODE = ord("X") - ord("A")

# Device memory policy, derived from the device's own size
# (utils.device_memory_bytes): half of it is the predict budget (the rest
# holds the resident align database and XLA's own buffers).  A launch's
# peak is at most PEAK_PER_ONEHOT times its (Qc, n_pad, L_pad, 26) f32
# one-hot volume, times DEPTH launches in flight.  XLA's memory analysis
# of the compiled launch (compiled_peak_ratio) reads 1.05x (one query) to
# 2.05x (four) on the CPU and 0.06x on an H100, where the one-hot fuses
# into its consumers; 3 covers both.
PEAK_PER_ONEHOT = 3
Q_CHUNK_MAX = 64          # queries per launch, at most
ROWS_PAD_MAX = 448        # row pad of the largest selection (Q7 cap + query)
# SIFT4G_TPU_PREDICT_QCHUNK forces a launch width; 0 = derived per bucket
Q_CHUNK = _env_int("SIFT4G_TPU_PREDICT_QCHUNK", "0")
# longest query the device path accepts (longer ones go to the host
# oracle); 0 = derived from the device's memory (max_device_query_len)
MAX_DEVICE_QUERY_LEN = _env_int("SIFT4G_TPU_PREDICT_MAX_QLEN", "0")

# device launches kept in flight: two-deep keeps the device busy while the
# host packs/fetches; each extra slot pins one more (Qc, n_pad, L_pad, 26)
# result + one packed input in device memory.
DEPTH = _env_int("SIFT4G_TPU_PREDICT_DEPTH", "2")


def _budget_bytes() -> int:
    from ..utils import device_memory_bytes

    limit = device_memory_bytes()
    if limit is None:
        raise RuntimeError(
            "device prediction needs the device's memory size, which it "
            "does not report; use --predict-backend host"
        )
    return limit // 2


def _onehot_bytes(l_pad: int, n_pad: int) -> int:
    return n_pad * l_pad * 26 * 4


def chunk_width(l_pad: int, n_pad: int, budget: int) -> int:
    """Queries per launch for one (L_pad, n_pad) bucket: the largest power
    of two <= Q_CHUNK_MAX whose DEPTH launches fit the budget (>= 1)."""
    per = PEAK_PER_ONEHOT * max(1, DEPTH) * _onehot_bytes(l_pad, n_pad)
    q = Q_CHUNK_MAX
    while q > 1 and q * per > budget:
        q //= 2
    return q


def compiled_peak_ratio(q: int, n_pad: int, l_pad: int) -> float:
    """Peak bytes of one compiled (q, n_pad, l_pad) predict launch — XLA's
    memory analysis for the device in use: arguments + outputs + temps —
    over its one-hot volume; the reading PEAK_PER_ONEHOT must cover."""
    import jax
    import jax.numpy as jnp

    from .scores_jax import sift_scores_from_rows_batch

    ma = sift_scores_from_rows_batch.lower(
        jax.ShapeDtypeStruct((q, n_pad, l_pad), jnp.int8),
        jax.ShapeDtypeStruct((q,), jnp.int32),
    ).compile().memory_analysis()
    peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    return peak / (q * _onehot_bytes(l_pad, n_pad))


def max_device_query_len() -> int:
    """Longest query whose largest bucket (ROWS_PAD_MAX rows) still fits one
    query per launch in the device's predict budget."""
    if MAX_DEVICE_QUERY_LEN:
        return MAX_DEVICE_QUERY_LEN
    per_aa = PEAK_PER_ONEHOT * max(1, DEPTH) * _onehot_bytes(1, ROWS_PAD_MAX)
    return int(_budget_bytes() // per_aa) // 128 * 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_shapes(
    lens: Sequence[int], n_rows: Sequence[int]
) -> Dict[Tuple[int, int], List[int]]:
    """Group query indices by (L_pad, n_pad) compile-shape bucket.

    L pads to 128, rows to 64 — a handful of distinct compiled shapes per
    run."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (L, n) in enumerate(zip(lens, n_rows)):
        key = (_round_up(max(L, 1), 128), _round_up(max(n, 1), 64))
        buckets.setdefault(key, []).append(i)
    return buckets


def predict_matrix_batch(
    queries: List[Chain],
    prepared_rows: List[np.ndarray],
    out_dir: str,
    q_chunk: int = 0,  # 0 = auto (env override, else derived per bucket)
    threads: int = 8,
    metrics=None,
    finishers=None,
) -> None:
    """Score + write .SIFTprediction files for device-batched queries.

    prepared_rows[i]: (n_i, L_i) int codes with the query as row 0
    (predict.prepare_rows output — Q7 cap and identity filter applied).

    ``finishers``: optional per-query callables ``f(scores_f32)`` (scores
    trimmed to the query's true length) that complete the query instead
    of the default full-matrix write — the subst-mode hybrid
    (predict_subst.finish_subst_query) plugs in here, so substitution
    and matrix queries share the same device launches and pipeline.

    Software-pipelined: JAX dispatch is async, so
    chunk k+1 is packed and dispatched BEFORE chunk k's result is fetched
    — the host packing and the per-query file writes (independent,
    fanned over a thread pool like the reference's per-query prediction
    tasks, sift_prediction.cpp:144-171) run under the device compute
    instead of serializing with it.
    """
    import jax.numpy as jnp
    from concurrent.futures import ThreadPoolExecutor

    from .scores_jax import sift_scores_from_rows_batch

    q_chunk = q_chunk or Q_CHUNK
    budget = None if q_chunk else _budget_bytes()

    lens = [r.shape[1] for r in prepared_rows]
    n_rows = [r.shape[0] for r in prepared_rows]
    buckets = bucket_shapes(lens, n_rows)

    widths = {
        key: q_chunk or chunk_width(key[0], key[1], budget) for key in buckets
    }
    chunks = [
        idxs[start : start + widths[key]]
        for key, idxs in sorted(buckets.items())
        for start in range(0, len(idxs), widths[key])
    ]
    shapes = {
        qi: key for key, idxs in buckets.items() for qi in idxs
    }

    pack_pool = None  # bound to the writer pool inside the run loop

    def dispatch(chunk):
        L_pad, n_pad = shapes[chunk[0]]
        q_chunk = widths[(L_pad, n_pad)]
        # fixed chunk width: the last partial chunk pads with all-'X'
        # dummy queries (results discarded) instead of forcing a fresh
        # compile shape.  int8 codes (0..25 fit easily): the tensor feeds
        # only one_hot on device, and the transfer + host memset are 4x
        # smaller than an int32 layout
        packed = np.empty((q_chunk, n_pad, L_pad), dtype=np.int8)
        n_valid = np.ones(q_chunk, dtype=np.int32)

        # per-row fills write disjoint slices and release the GIL in the
        # memset/memcpy, so they fan over the host pool
        def fill(j):
            if j < len(chunk):
                r = prepared_rows[chunk[j]]
                packed[j, : r.shape[0], : r.shape[1]] = r
                packed[j, r.shape[0] :, :] = X_CODE
                packed[j, : r.shape[0], r.shape[1] :] = X_CODE
                n_valid[j] = r.shape[0]
            else:  # dummy query pads the last partial chunk
                packed[j] = X_CODE

        if pack_pool is not None:
            list(pack_pool.map(fill, range(q_chunk)))
        else:
            for j in range(q_chunk):
                fill(j)
        return sift_scores_from_rows_batch(jnp.asarray(packed), jnp.asarray(n_valid))

    def write_one(args):
        scores_row, qi = args
        fin = finishers[qi] if finishers is not None else None
        if fin is not None:
            fin(scores_row[: lens[qi]])
            return
        out_path = create_file_name(queries[qi].name, out_dir, ".SIFTprediction")
        write_matrix_original_format(
            scores_row[: lens[qi]].astype(np.float64), out_path
        )

    import time as _time
    from collections import deque

    t_pack = t_fetch = 0.0
    depth = max(1, DEPTH)
    # the writer pool drains thousands of queued matrix-file writes; fills
    # must NOT share it (pool.map would enqueue them behind every pending
    # write — measured as predict.pack absorbing the writers' runtime).
    # 4 fill workers saturate this host's memcpy bandwidth.
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool, \
            ThreadPoolExecutor(max_workers=4) as fill_pool:
        pack_pool = fill_pool
        pending = deque()  # (device result, chunk): <= depth in flight
        write_futs = []

        def drain_one():
            nonlocal t_fetch
            dev, prev = pending.popleft()
            t0 = _time.perf_counter()
            scores = np.asarray(dev)  # the only blocking fetch
            t_fetch += _time.perf_counter() - t0
            write_futs.extend(
                pool.submit(write_one, (scores[j], qi))
                for j, qi in enumerate(prev)
            )

        for chunk in chunks:
            t0 = _time.perf_counter()
            pending.append((dispatch(chunk), chunk))
            t_pack += _time.perf_counter() - t0
            if len(pending) >= depth:
                drain_one()
        while pending:
            drain_one()
        t0 = _time.perf_counter()
        for f in write_futs:
            f.result()  # surface writer exceptions
    if metrics is not None:
        metrics.add("predict.pack", seconds=t_pack)
        metrics.add("predict.fetch", seconds=t_fetch)
        metrics.add("predict.writedrain", seconds=_time.perf_counter() - t0)

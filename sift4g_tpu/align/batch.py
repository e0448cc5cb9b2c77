"""Host-facing batched scoring: bucketing, packing, and launch policy.

Backends (all produce exact, byte-identical integer scores):

* ``pallas`` (GPU production) — every (query, target-bucket) pair of a
  call packs into grid-of-groups launches of the Pallas-Triton kernel
  (pallas_sw.py): fixed 8/64-group grids, a geometric padded-length
  ladder, batch width bounded by a per-group cell budget, int8 code
  transfers (or offsets into the device-resident database), in-order
  asynchronous dispatch and one deferred fetch.
* ``xla`` — the same launch policy over the plain XLA scan (align/xla.py).
* ``native`` — the threaded C++ DP (CPU-only deployments).
* ``numpy`` — the oracle (tests / ground truth).

With more than one device, pallas/xla score through the group-sharded
shard_map path (parallel/sharded.py).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..core.scorers import Scorer
from ..utils import env_int as _env_int
from .dp_numpy import score_pair

PAD_CODE = 31

_MODE_IDS = {"SW": 0, "NW": 1, "HW": 2, "OV": 3}


class PackedTargets:
    """Candidate targets as (codes_base, starts, lens) arrays.

    Per-target Python objects dominate dispatch at high query counts; this
    form lets the grouped path bucket and pack with pure array math and
    pointer arithmetic.  Indexing/iteration materialize zero-copy views
    so every other backend consumes it like a list of arrays.
    """

    __slots__ = ("codes", "starts", "lens")

    def __init__(self, codes: np.ndarray, starts: np.ndarray, lens: np.ndarray):
        self.codes = codes
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lens = np.asarray(lens, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.lens.shape[0])

    def __getitem__(self, i: int) -> np.ndarray:
        s = self.starts[i]
        return self.codes[s : s + self.lens[i]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def total_len(self) -> int:
        return int(self.lens.sum())


def _targets_total_len(targets) -> int:
    if isinstance(targets, PackedTargets):
        return targets.total_len()
    return sum(t.shape[0] for t in targets)


class ResidentDB:
    """Database codes resident in device memory.

    Grouped launches against it ship only (G, B) int32 offset/length
    arrays instead of (G, B, N) target bytes; the kernel reads each target
    at its offset (sw_scores_pallas_grouped_resident).  The array uploads
    once per process and is reused across serve-daemon jobs via
    :func:`get_resident_db`.

    The kernel addresses targets by int32 element offsets, so the codes
    are cut into SEGMENTS below 2 GiB at sequence granularity; each
    launch reads from exactly one segment (the bucketing keys resident
    groups by segment).

    ``host`` is the caller's host codes array itself: PackedTargets built
    over it (absolute int64 starts) serve every non-resident consumer
    (traceback) with the same (codes, starts, lens) contract, and the
    launch path recognizes its identity to ship offsets only.
    """

    # device-array size rung: each distinct array size is a distinct jit
    # shape, so segments are rounded up to a common grain
    DEV_GRAIN = 128 * 1024 * 1024
    # max codes per segment: the grain-ROUNDED device array must stay
    # below 2 GiB (int32 element offsets)
    SEG_CAP = 15 * DEV_GRAIN

    def __init__(self, host_codes: np.ndarray, offsets: np.ndarray,
                 mesh=None):
        import jax

        # under a mesh the segment arrays are REPLICATED across devices
        # (each device holds the full segment — the reference gives every
        # card the whole filtered chain database too,
        # database_alignment.cpp:80-81)
        self.mesh = mesh
        self.host = host_codes
        self.offsets = np.asarray(offsets, dtype=np.int64)
        n_seq = self.offsets.shape[0] - 1
        lens = np.diff(self.offsets)
        if lens.size and int(lens.max()) > self.SEG_CAP:
            raise ValueError("a single sequence exceeds the segment capacity")
        rel = self.offsets - self.offsets[0]
        seg_first = [0]
        while seg_first[-1] < n_seq:
            i = seg_first[-1]
            j = int(np.searchsorted(rel, rel[i] + self.SEG_CAP, side="right")) - 1
            seg_first.append(min(max(j, i + 1), n_seq))
        self.seg_base = self.offsets[np.asarray(seg_first, dtype=np.int64)]
        self.n_segs = len(seg_first) - 1
        self.nbytes = int(rel[-1])

        self.dev = []
        for s in range(self.n_segs):
            lo, hi = int(self.seg_base[s]), int(self.seg_base[s + 1])
            size = max(-(-(hi - lo) // self.DEV_GRAIN), 1) * self.DEV_GRAIN
            view = host_codes[lo : lo + size]
            if view.shape[0] < size:  # zero-fill the tail to the rung
                view = np.concatenate(
                    [view, np.zeros(size - view.shape[0], dtype=np.uint8)]
                )
            if mesh is not None:
                from ..parallel.sharded import replicate_to_mesh

                self.dev.append(replicate_to_mesh(mesh, view))
            else:
                self.dev.append(jax.device_put(view))

    def seg_of_starts(self, starts: np.ndarray) -> np.ndarray:
        """Segment index for each absolute start offset."""
        if self.n_segs == 1:
            return np.zeros(starts.shape[0], dtype=np.int64)
        return np.searchsorted(self.seg_base, starts, side="right") - 1

    def packed_targets(self, ids: np.ndarray, lens: np.ndarray) -> PackedTargets:
        """(codes, starts, lens) over the host codes for record ids (local
        to this database slice) — consumable by every backend; the
        resident launch path recognizes the identity of ``codes`` and
        ships offsets only."""
        return PackedTargets(self.host, self.offsets[ids], lens)


_RESIDENT_CACHE: dict = {}


def _resident_key(host_codes: np.ndarray, offsets: np.ndarray, mesh=None):
    # backing file + record span: a multi-host shard of the same file is
    # a DIFFERENT resident layout.  The mesh is part of the identity: a
    # replicated upload differs from a single-device one
    return (getattr(host_codes, "filename", None)
            or getattr(getattr(host_codes, "base", None), "filename", None)
            or id(host_codes),
            int(host_codes.shape[0]),
            int(offsets.shape[0]),
            int(offsets[0]) if offsets.shape[0] else 0,
            int(offsets[-1]) if offsets.shape[0] else 0,
            None if mesh is None else tuple(d.id for d in mesh.devices.flat))


def resident_db_cached(host_codes: np.ndarray, offsets: np.ndarray,
                       mesh=None) -> bool:
    """True when the live ResidentDB already holds this database slice
    (its upload cost is sunk — serve-daemon jobs and warm repeats)."""
    return _RESIDENT_CACHE.get("key") == _resident_key(host_codes, offsets, mesh)


def get_resident_db(host_codes: np.ndarray, offsets: np.ndarray,
                    mesh=None) -> ResidentDB:
    """One live ResidentDB at a time, keyed by (backing file, record
    span, mesh) so serve-daemon jobs on the same database reuse the
    upload."""
    key = _resident_key(host_codes, offsets, mesh)
    if _RESIDENT_CACHE.get("key") != key:
        _RESIDENT_CACHE.clear()
        db = ResidentDB(host_codes, offsets, mesh)  # key set only on
        # success: a failed build must not poison the cache
        # (resident_db_cached would report a live upload forever)
        _RESIDENT_CACHE["key"] = key
        _RESIDENT_CACHE["db"] = db
    return _RESIDENT_CACHE["db"]


def grouped_local_step(impl, resident_npad, screen_k, *, mode, gap_open,
                       gap_extend, max_qlen=0):
    """The ONE kernel-selection site for grouped scoring: picks the GPU
    kernel ("pallas") or the XLA scan ("xla"), slab or resident,
    optionally fusing device-side E-value screening (align/xla.py
    screen_topk_words) into the same jitted step.  Consumed by the
    single-device jit factory below AND the shard_map factories in
    parallel/sharded.py, so the screened mesh and single-device paths
    cannot diverge.  A screened step takes a trailing (G,) int32
    threshold array and returns (G, screen_k) words; ``resident_npad`` > 0
    selects the resident variants (signature gains the flat db array).
    ``max_qlen`` bounds the XLA scan's rows (the kernel loops to each
    group's own length)."""
    from .pallas_sw import (
        sw_scores_pallas_grouped,
        sw_scores_pallas_grouped_resident,
    )
    from .xla import (
        align_scores_grouped,
        align_scores_grouped_resident,
        screen_topk_words,
    )

    kw = dict(mode=mode, gap_open=gap_open, gap_extend=gap_extend)
    if resident_npad:
        if impl == "xla":
            def base(q, go, gl, db, ts, tl, m32):
                return align_scores_grouped_resident(
                    q, go, gl, db, ts, tl, m32, resident_npad,
                    m_window=max_qlen, **kw)
        else:
            def base(q, go, gl, db, ts, tl, m32):
                return sw_scores_pallas_grouped_resident(
                    q, go, gl, db, ts, tl, m32, resident_npad, **kw)
    elif impl == "xla":
        def base(q, go, gl, tg, tl, m32):
            return align_scores_grouped(
                q, go, gl, tg, tl, m32, m_window=max_qlen, **kw)
    else:
        def base(q, go, gl, tg, tl, m32):
            return sw_scores_pallas_grouped(q, go, gl, tg, tl, m32, **kw)
    if not screen_k:
        return base

    def fn(*args):
        *a, smin = args
        return screen_topk_words(base(*a), smin, screen_k)

    return fn


_GROUPED_SINGLE_CACHE: dict = {}


def _grouped_single_fn(impl, resident_npad, screen_k, *, mode, gap_open,
                       gap_extend, max_qlen):
    """Cached jitted single-device grouped scorer."""
    key = (impl, resident_npad, screen_k, mode, gap_open, gap_extend,
           max_qlen)
    if key not in _GROUPED_SINGLE_CACHE:
        import jax

        _GROUPED_SINGLE_CACHE[key] = jax.jit(grouped_local_step(
            impl, resident_npad, screen_k, mode=mode, gap_open=gap_open,
            gap_extend=gap_extend, max_qlen=max_qlen,
        ))
    return _GROUPED_SINGLE_CACHE[key]


def _length_rungs_vec(lens: np.ndarray, base: int) -> np.ndarray:
    """Vectorized _length_rung over an int array (exact next-pow2 via
    frexp: no float-log rounding hazards)."""
    k = -(-np.maximum(lens, 1) // base)
    m, e = np.frexp(k.astype(np.float64))
    p = np.where(m == 0.5, np.left_shift(1, e - 1), np.left_shift(1, e))
    p34 = (p // 4) * 3
    p = np.where((p >= 4) & (p34 >= k), p34, p)
    return (p * base).astype(np.int64)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _length_rung(n: int, base: int) -> int:
    """Padded-length ladder base * {1, 2, 3, 4, 6, 8, 12, 16, ...}: bounds
    the number of compiled kernel shapes with <= 1.5x padding waste."""
    k = -(-max(n, 1) // base)          # ceil multiple of base
    p = 1
    while p < k:
        p *= 2
    if p >= 4 and 3 * p // 4 >= k:     # 3 * 2^a rung between powers of two
        p = 3 * p // 4
    return base * p


def align_pairs_batch(
    query_codes: np.ndarray,
    targets: Sequence[np.ndarray],
    scorer: Scorer,
    mode: str = "SW",
    threads: int = 0,
):
    """Score + traceback for one query vs many targets.

    Uses the threaded native aligner (native/aligner.cpp) when available,
    else the NumPy oracle per pair.  ``threads`` mirrors the reference's
    -t (main.cpp:188 feeds its pool size everywhere); 0 = hardware
    concurrency.  Returns a list of AlignmentRecord.
    """
    from ..native import load as _load_native
    from .dp_numpy import align_pair
    from .records import AlignmentRecord

    if not targets:
        return []
    lib = _load_native()
    if lib is None:
        return [align_pair(query_codes, t, scorer, mode) for t in targets]

    import ctypes

    n = len(targets)
    q = np.ascontiguousarray(query_codes, dtype=np.uint8)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, t in enumerate(targets):
        offsets[i + 1] = offsets[i] + t.shape[0]
    concat = np.empty(int(offsets[-1]), dtype=np.uint8)
    for i, t in enumerate(targets):
        concat[offsets[i] : offsets[i + 1]] = t
    matrix26 = np.ascontiguousarray(scorer.matrix, dtype=np.int32)

    score = np.empty(n, dtype=np.int32)
    qs = np.empty(n, dtype=np.int32)
    qe = np.empty(n, dtype=np.int32)
    ts = np.empty(n, dtype=np.int32)
    te = np.empty(n, dtype=np.int32)
    cap = int(offsets[-1]) + n * (q.shape[0] + 1)
    moves_buf = np.empty(cap, dtype=np.uint8)
    moves_off = np.empty(n + 1, dtype=np.int64)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.sift4g_align_batch(
        q.ctypes.data_as(u8p), q.shape[0],
        concat.ctypes.data_as(u8p), offsets.ctypes.data_as(i64p), n,
        matrix26.ctypes.data_as(i32p),
        scorer.gap_open, scorer.gap_extend, _MODE_IDS[mode],
        max(int(threads), 0),
        score.ctypes.data_as(i32p), qs.ctypes.data_as(i32p),
        qe.ctypes.data_as(i32p), ts.ctypes.data_as(i32p),
        te.ctypes.data_as(i32p),
        moves_buf.ctypes.data_as(u8p), cap,
        moves_off.ctypes.data_as(i64p),
    )
    if rc != 0:  # moves overflow cannot happen with cap = sum(n_i) + n*(m+1)
        return [align_pair(query_codes, t, scorer, mode) for t in targets]

    out = []
    for i, t in enumerate(targets):
        out.append(
            AlignmentRecord(
                score=int(score[i]),
                query_start=int(qs[i]),
                query_end=int(qe[i]),
                target_start=int(ts[i]),
                target_end=int(te[i]),
                moves=moves_buf[moves_off[i] : moves_off[i + 1]].copy(),
                query_codes=query_codes,
                target_codes=t,
            )
        )
    return out


def score_pairs_batch(
    query_codes: np.ndarray,
    targets,
    scorer: Scorer,
    mode: str = "SW",
    threads: int = 0,
) -> np.ndarray:
    """Scores only (int64 array) for one query vs many targets.

    Threaded linear-memory C++ DP (native/aligner.cpp sift4g_score_batch)
    — the CPU scoring twin of the device kernels: no traceback
    matrices, ~4x align_pairs_batch.  PackedTargets passes its
    (codes, starts, lens) arrays zero-copy.  Falls back to the NumPy
    oracle when the native library (or the symbol, stale .so) is absent.
    """
    from ..native import load as _load_native
    from .dp_numpy import score_pair

    n = len(targets)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    lib = _load_native()
    if lib is None or not hasattr(lib, "sift4g_score_batch"):
        return np.array(
            [score_pair(query_codes, t, scorer, mode) for t in targets],
            dtype=np.int64,
        )

    import ctypes

    q = np.ascontiguousarray(query_codes, dtype=np.uint8)
    if isinstance(targets, PackedTargets):
        base = np.ascontiguousarray(targets.codes, dtype=np.uint8)
        starts = np.ascontiguousarray(targets.starts, dtype=np.int64)
        lens = np.ascontiguousarray(targets.lens, dtype=np.int32)
    else:
        lens = np.fromiter(
            (t.shape[0] for t in targets), dtype=np.int32, count=n
        )
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        base = np.empty(int(starts[-1]) + int(lens[-1]), dtype=np.uint8)
        for i, t in enumerate(targets):
            base[starts[i] : starts[i] + lens[i]] = t
    matrix26 = np.ascontiguousarray(scorer.matrix, dtype=np.int32)
    score = np.empty(n, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sift4g_score_batch(
        q.ctypes.data_as(u8p), q.shape[0],
        base.ctypes.data_as(u8p),
        starts.ctypes.data_as(i64p), lens.ctypes.data_as(i32p), n,
        matrix26.ctypes.data_as(i32p),
        scorer.gap_open, scorer.gap_extend, _MODE_IDS[mode],
        max(int(threads), 0),
        score.ctypes.data_as(i32p),
    )
    return score.astype(np.int64)


class BatchAligner:
    """Scores one query against many targets; backend 'pallas' | 'xla' |
    'native' | 'numpy'."""

    def __init__(
        self,
        scorer: Scorer,
        mode: str = "SW",
        backend: str = "auto",
        q_bucket: int = 64,
        t_bucket: int = 128,
        b_cap: int = 0,
        resident: "ResidentDB | None" = None,
        tail_policy: str = "",
        threads: int = 0,
        cards: "tuple | None" = None,
    ):
        if backend == "auto":
            from . import best_backend

            backend = best_backend()
        self.scorer = scorer
        self.mode = mode
        self.backend = backend
        self.q_bucket = q_bucket
        # target rung ladder base
        self.t_bucket = _env_int("SIFT4G_TPU_T_BUCKET", t_bucket)
        # native-backend thread count (reference -t; 0 = hw concurrency)
        self.threads = threads
        # optional grouped-batch width cap: tests bound interpret-mode work
        # with it (production leaves 0 = the cell-budget policy only)
        self.b_cap = b_cap
        # tail-group width policy for the grouped path.  "pow2" (default)
        # shrinks the one tail group per (query, rung) to the smallest
        # 256*2^k >= remainder; "full" pads every remainder to the bucket's
        # full batch width.  Scores are bit-identical either way (padding
        # lanes are masked); tests assert equality across policies.
        # SIFT4G_TPU_TAIL_POLICY=full is the control.
        self.tail_policy = tail_policy or os.environ.get(
            "SIFT4G_TPU_TAIL_POLICY", "pow2"
        )
        if self.tail_policy not in ("full", "pow2"):
            raise ValueError(
                f"tail_policy must be 'full' or 'pow2', got {self.tail_policy!r}"
            )
        # cross-rung tail coalescing: a query's remainder targets from
        # SMALLER rungs join the largest rung's tail group when the merged
        # pow2 group costs fewer padded cells than separate per-rung tails
        # — exact, because target lengths are masked at any rung >= the
        # length, and every group still carries one query.
        # SIFT4G_TPU_TAIL_COALESCE=0 is the control.
        self.tail_coalesce = os.environ.get(
            "SIFT4G_TPU_TAIL_COALESCE", "1"
        ) != "0"
        # grouped kernel: "pallas" (the GPU kernel) or "xla" (the exact
        # plain scan).  backend="xla" rides the SAME grouped packing and
        # launch policy with the scan; tests may set the attribute to
        # exercise backend="pallas"-gated paths (the resident database)
        # through the scan.
        self.grouped_impl = "xla" if backend == "xla" else "pallas"
        self._matrix32 = None
        self._mesh = None
        # kernel-launch counter: launches must scale with (bucket, G_CHUNK)
        # chunks, never with queries x buckets
        self.launches = 0
        # device-resident database: grouped launches ship offsets, not
        # bytes.  Works single-device AND under a mesh (segments
        # replicated per device, launches group-axis-sharded via
        # parallel.sharded.make_grouped_resident_sharded)
        self.resident = resident
        # device selection (reference --cards, main.cpp:254-262): an
        # explicit card list always builds a mesh over exactly those local
        # devices; without cards, a mesh is built only when >1 device
        # exists.  A mesh that cannot be built is an error, never a
        # silent fall back to one device.
        self.cards = tuple(cards) if cards else None
        if backend in ("xla", "pallas"):
            import jax

            if self.cards or len(jax.devices()) > 1:
                from ..parallel.sharded import make_mesh

                self._mesh = make_mesh(cards=self.cards)

    def _group_width(self, count: int, bcap: int) -> int:
        """Batch width for one group of ``count`` targets (tail policy)."""
        if self.tail_policy != "pow2" or count >= bcap:
            return bcap
        bw = 256
        while bw < count:
            bw *= 2
        return min(bw, bcap)

    def _coalesce_tails(self, tails, b_for):
        """Merge one (item, segment)'s per-rung remainder groups upward.

        ``tails``: list of (n_pad, idx_array) — the sub-batch-width
        remainder of each rung.  Greedy largest-rung-first: a smaller
        rung's remainder joins the current pool at rung R when the merged
        group costs fewer padded cells (_group_width(total) * R) than the
        two separate groups AND fits rung R's batch cap.  Scores are
        unchanged — the kernel masks every column past a target's length,
        so a target is exact at any rung >= its length (the same invariant
        the rung ladder itself relies on).  Returns [(n_pad, idx_array)].
        """
        if not self.tail_coalesce or len(tails) <= 1:
            return tails
        tails = sorted(tails, key=lambda t: -t[0])
        out = []
        R, pool = tails[0]
        for r, idxs in tails[1:]:
            cap = b_for(R)
            merged = len(pool) + len(idxs)
            cost_merged = self._group_width(merged, cap) * R
            cost_split = (
                self._group_width(len(pool), cap) * R
                + self._group_width(len(idxs), b_for(r)) * r
            )
            if merged <= cap and cost_merged <= cost_split:
                pool = np.concatenate([pool, idxs])
            else:
                out.append((R, pool))
                R, pool = r, idxs
        out.append((R, pool))
        return out

    def _matrix32_dev(self):
        if self._matrix32 is None:
            from .xla import _extend_matrix
            import jax.numpy as jnp

            self._matrix32 = jnp.asarray(_extend_matrix(self.scorer.matrix))
        return self._matrix32

    def scores(self, query_codes: np.ndarray, targets: Sequence[np.ndarray]) -> np.ndarray:
        return self.scores_many([(query_codes, targets)])[0]

    def scores_many(self, items) -> List[np.ndarray]:
        return self.scores_many_async(items)()

    def scores_many_async(self, items, screen=None):
        """Dispatch scoring for many (query_codes, targets) pairs; returns a
        zero-arg fetch closure producing List[np.ndarray].

        All per-bucket kernel calls go out asynchronously and the results
        are fetched with ONE host round trip when the closure runs; the
        split lets the caller overlap host work (IO, packing) with device
        scoring.

        ``screen=(smins, k)`` opts into device-side exact E-value
        screening: ``smins[i]`` is item i's integer passing-score
        threshold (core.evalue.min_passing_score) and ``k`` the per-query
        alignment cap; screened launches fetch (G, k) survivor words
        instead of (G, B) scores (align/xla.py screen_topk_words).
        Non-survivor slots come back as 0 in the dense result arrays —
        exact for callers that filter by ``score >= smins[i]``, which by
        construction equals the ``evalues(score) <= max_evalue`` set.
        Backends without screening simply return full scores (also exact
        under the same filter).
        """
        if self.backend == "numpy":
            res = [
                np.array(
                    [score_pair(q, t, self.scorer, self.mode) for t in targets],
                    dtype=np.int64,
                )
                for q, targets in items
            ]
            return lambda: res
        if self.backend == "native":
            # threaded linear-memory C++ DP (no traceback matrices) — the
            # fast CPU-only deployment path
            res = [
                score_pairs_batch(
                    q, t, self.scorer, self.mode, threads=self.threads
                )
                for q, t in items
            ]
            return lambda: res
        # single-device AND mesh, kernel AND scan: one grouped
        # packing/launch policy; with a mesh each launch's group axis is
        # sharded across devices (parallel/sharded.make_grouped_sharded)
        return self._scores_grouped(items, screen)

    def _scores_grouped(self, items, screen=None):
        """Pack every (query, target-bucket) pair into grid-of-groups
        launches — one launch per (length rung, G_CHUNK groups) instead of
        one per pair.  Returns a zero-arg fetch closure (see
        scores_many_async)."""
        import jax.numpy as jnp

        from .xla import SCREEN_MAX_SCORE, decode_screen_words

        out = [np.zeros(len(t), dtype=np.int64) for _, t in items]
        n_dev = 1 if self._mesh is None else int(self._mesh.devices.size)

        # widest batch whose group stays near 2**19 cells: a launch's
        # device working set (int8 slab + the kernel's int32 H/F strip
        # scratch, ~9 bytes per group cell) stays ~300 MB at G=64, while
        # every group still spans many 128-lane programs
        def b_for(n_pad: int) -> int:
            b = (1 << 19) // n_pad // 256 * 256
            b = int(max(256, min(4096, b)))
            return min(b, self.b_cap) if self.b_cap else b

        # padded query codes per item; every launch builds its OWN small
        # concatenated buffer (<= G_CHUNK distinct queries)
        q_lens = []
        q_chunks = []
        for query_codes, _ in items:
            m = query_codes.shape[0]
            m_pad = _round_up(max(m, 1), self.q_bucket)
            qa = np.full(m_pad, PAD_CODE, dtype=np.int32)
            qa[:m] = query_codes
            q_chunks.append(qa)
            q_lens.append(m)

        # device-side E-value screening gate: every item needs a valid
        # integer threshold (>= 1, so padded rows never survive) and the
        # largest possible score must fit the 19-bit word field
        scr_k, smins = 0, None
        if screen is not None:
            smins, scr_k = screen
            max_sub_scr = int(self.scorer.matrix.max())
            if (
                scr_k < 1
                or len(smins) != len(items)
                or any(s is None or s < 1 for s in smins)
                or (q_lens and max(q_lens) * max_sub_scr > SCREEN_MAX_SCORE)
            ):
                scr_k, smins = 0, None

        # bucket every target by its padded length (and, for resident-backed
        # targets, by device segment — a launch reads one segment), then
        # chunk each per-query bucket into groups of that bucket's width
        buckets = {}   # (n_pad, B, seg) -> list of (item_idx, chunk_idx array)
        for item_idx, (_, targets) in enumerate(items):
            if len(targets) == 0:
                continue
            if isinstance(targets, PackedTargets):
                # vectorized bucketing: rung per target, grouped with one
                # argsort — no per-target Python
                rungs = _length_rungs_vec(targets.lens, self.t_bucket)
                res_segs = None
                if (
                    self.resident is not None
                    and self.resident.n_segs > 1
                    and targets.codes is self.resident.host
                ):
                    res_segs = self.resident.seg_of_starts(targets.starts)
                    key = rungs * self.resident.n_segs + res_segs
                else:
                    key = rungs
                order = np.argsort(key, kind="stable")
                uniq, first = np.unique(key[order], return_index=True)
                per_np = {}
                for u in range(len(uniq)):
                    idxs = order[first[u] : (first[u + 1] if u + 1 < len(first) else len(order))]
                    if res_segs is None:
                        per_np[(int(uniq[u]), 0)] = idxs
                    else:
                        n_pad, seg = divmod(int(uniq[u]), self.resident.n_segs)
                        per_np[(n_pad, seg)] = idxs
            else:
                per_np = {}
                for i, t in enumerate(targets):
                    n_pad = _length_rung(t.shape[0], self.t_bucket)
                    per_np.setdefault((n_pad, 0), []).append(i)
            tails = {}  # seg -> [(n_pad, remainder idx array)]
            for (n_pad, seg), idxs in per_np.items():
                bcap = b_for(n_pad)
                n_full = len(idxs) // bcap * bcap
                for pos in range(0, n_full, bcap):
                    chunk_idx = np.asarray(idxs[pos : pos + bcap])
                    buckets.setdefault((n_pad, bcap, seg), []).append((item_idx, chunk_idx))
                if n_full < len(idxs):
                    tails.setdefault(seg, []).append(
                        (n_pad, np.asarray(idxs[n_full:]))
                    )
            for seg, tl_list in tails.items():
                for n_pad, chunk_idx in self._coalesce_tails(tl_list, b_for):
                    bw = self._group_width(len(chunk_idx), b_for(n_pad))
                    # ascending target order restores the id-ascending row
                    # invariant the screening word tie-order relies on
                    # (screen_topk_words docstring)
                    buckets.setdefault((n_pad, bw, seg), []).append(
                        (item_idx, np.sort(chunk_idx))
                    )

        matrix32 = self._matrix32_dev()
        devs = []      # (dev_scores (G_pad, B), B, groups, k_eff)
        from ..native import load as _load_native

        native_lib = _load_native()
        if native_lib is not None:
            import ctypes

            _u64p = ctypes.POINTER(ctypes.c_uint64)
            _i32p = ctypes.POINTER(ctypes.c_int32)
            _i8p = ctypes.POINTER(ctypes.c_int8)

        # resident fast path: applies when every item of a launch is a
        # PackedTargets view over the resident host array (the pipeline
        # constructs them that way) — the launch then ships (G, B) int32
        # offset/length arrays instead of a (G, B, N) byte slab
        def _part_resident(part):
            if self.resident is None:
                return False
            return all(
                isinstance(items[ii][1], PackedTargets)
                and items[ii][1].codes is self.resident.host
                for ii, _ in part
            )

        def _smin_for(part, G_CHUNK):
            """(G_CHUNK,) int32 per-group screening thresholds; dummy
            trailing groups get INT32_MAX so nothing survives there."""
            if not scr_k:
                return None
            arr = np.full(G_CHUNK, np.iinfo(np.int32).max, dtype=np.int32)
            for gi, (item_idx, _) in enumerate(part):
                arr[gi] = smins[item_idx]
            return arr

        def _query_buffer(part, G_CHUNK):
            """Per-launch query buffer (only the <= G_CHUNK distinct queries
            of this launch, ladder-padded so its shape does not vary per
            launch) plus per-group offsets and lengths."""
            go = np.zeros(G_CHUNK, dtype=np.int32)
            gl = np.zeros(G_CHUNK, dtype=np.int32)
            local_off = {}
            local_parts = []
            off = 0
            for gi, (item_idx, _) in enumerate(part):
                if item_idx not in local_off:
                    local_off[item_idx] = off
                    local_parts.append(q_chunks[item_idx])
                    off += q_chunks[item_idx].shape[0]
                go[gi] = local_off[item_idx]
                gl[gi] = q_lens[item_idx]
            q_local = np.full(_length_rung(max(off, 1), 512), PAD_CODE,
                              dtype=np.int32)
            if local_parts:
                q_local[:off] = np.concatenate(local_parts)
            return q_local, go, gl

        launch_args = []
        g_big = _env_int("SIFT4G_TPU_G_CHUNK", 64)
        for (n_pad, B, seg), groups in sorted(buckets.items()):
            # two fixed grid sizes per bucket shape (small jobs avoid
            # padding a 64-group launch); trailing dummy groups (qlen 0)
            # skip their row loop.  The grid divides across the mesh: each
            # device runs G_CHUNK / n_dev complete groups of the launch
            G_CHUNK = _round_up(8 if len(groups) <= 8 * n_dev else g_big, n_dev)
            for gpos in range(0, len(groups), G_CHUNK):
                part = groups[gpos : gpos + G_CHUNK]
                q_local, go, gl = _query_buffer(part, G_CHUNK)
                # the XLA scan's static row bound: ladder-bucketed query
                # length (a distinct value would force a recompile)
                max_qlen = _length_rung(
                    max((q_lens[ii] for ii, _ in part), default=1), self.q_bucket
                )
                smin = _smin_for(part, G_CHUNK)
                if _part_resident(part):
                    ts = np.zeros((G_CHUNK, B), dtype=np.int32)
                    tl = np.zeros((G_CHUNK, B), dtype=np.int32)
                    for gi, (item_idx, chunk_idx) in enumerate(part):
                        targets = items[item_idx][1]
                        ci = np.asarray(chunk_idx)
                        # segment-LOCAL int32 offsets (the bucketing keyed
                        # this launch's targets to one segment)
                        ts[gi, : ci.shape[0]] = (
                            targets.starts[ci] - self.resident.seg_base[seg]
                        )
                        tl[gi, : ci.shape[0]] = targets.lens[ci]
                    launch_args.append(
                        (q_local, go, gl, None, ts, tl, n_pad, seg, max_qlen,
                         B, part, smin)
                    )
                    continue
                if native_lib is not None:
                    # native memcpy fill; tails stay uninitialized — the
                    # kernel never reads past a target's length and the
                    # scan masks them (pack.cpp)
                    tg = np.empty((G_CHUNK, B, n_pad), dtype=np.int8)
                else:
                    tg = np.full((G_CHUNK, B, n_pad), PAD_CODE, dtype=np.int8)
                tl = np.zeros((G_CHUNK, B), dtype=np.int32)
                for gi, (item_idx, chunk_idx) in enumerate(part):
                    targets = items[item_idx][1]
                    if native_lib is not None:
                        if isinstance(targets, PackedTargets):
                            # pure pointer arithmetic: base + starts[sel]
                            base = targets.codes.ctypes.data
                            ci = np.asarray(chunk_idx)
                            ptrs = (base + targets.starts[ci]).astype(np.uint64)
                            lens_in = np.ascontiguousarray(targets.lens[ci])
                        else:
                            sel = [targets[i] for i in chunk_idx]
                            ptrs = np.fromiter(
                                (t.ctypes.data for t in sel), dtype=np.uint64,
                                count=len(sel),
                            )
                            lens_in = np.fromiter(
                                (t.shape[0] for t in sel), dtype=np.int32,
                                count=len(sel),
                            )
                        native_lib.sift4g_pack_group(
                            ptrs.ctypes.data_as(_u64p),
                            lens_in.ctypes.data_as(_i32p),
                            int(lens_in.shape[0]),
                            n_pad,
                            tg[gi].ctypes.data_as(_i8p),
                            tl[gi].ctypes.data_as(_i32p),
                        )
                    else:
                        for r, i in enumerate(chunk_idx):
                            t = targets[i]
                            tg[gi, r, : t.shape[0]] = t
                            tl[gi, r] = t.shape[0]
                launch_args.append(
                    (q_local, go, gl, tg, None, tl, n_pad, seg, max_qlen, B,
                     part, smin)
                )

        def _launch(entry):
            (q_local, go, gl, tg, ts, tl, n_pad, seg, max_qlen, B, part,
             smin) = entry
            self.launches += 1
            k_eff = min(B, scr_k) if smin is not None else 0
            resident_npad = n_pad if tg is None else 0
            common = dict(mode=self.mode, gap_open=self.scorer.gap_open,
                          gap_extend=self.scorer.gap_extend)
            # only the scan takes the row bound (one jit per value); the
            # kernel loops to each group's own length
            max_qlen = max_qlen if self.grouped_impl == "xla" else 0
            if self._mesh is not None:
                from ..parallel import sharded

                if resident_npad:
                    fn = sharded.make_grouped_resident_sharded(
                        self._mesh, n_pad=n_pad, kernel=self.grouped_impl,
                        screen_k=k_eff, max_qlen=max_qlen, **common)
                else:
                    fn = sharded.make_grouped_sharded(
                        self._mesh, kernel=self.grouped_impl, screen_k=k_eff,
                        max_qlen=max_qlen, **common)
            else:
                fn = _grouped_single_fn(
                    self.grouped_impl, resident_npad, k_eff,
                    max_qlen=max_qlen, **common)
            args = [jnp.asarray(q_local), jnp.asarray(go), jnp.asarray(gl)]
            if resident_npad:
                args += [self.resident.dev[seg], jnp.asarray(ts)]
            else:
                args.append(jnp.asarray(tg))
            args += [jnp.asarray(tl), matrix32]
            if k_eff:
                args.append(jnp.asarray(smin))
            return fn(*args), B, part, k_eff

        # in-order dispatch: each call returns once its work is enqueued
        devs.extend(_launch(e) for e in launch_args)

        def fetch() -> List[np.ndarray]:
            if not devs:
                return out
            flat = np.asarray(
                jnp.concatenate([d.reshape(-1) for d, _, _, _ in devs])
            )
            pos = 0
            for dev, b, groups, k_eff in devs:
                g_pad = dev.shape[0]
                w = k_eff if k_eff else b
                for gi, (item_idx, chunk_idx) in enumerate(groups):
                    seg = flat[pos + gi * w : pos + (gi + 1) * w]
                    if k_eff:
                        # screened launch: decode survivor words; every
                        # other slot keeps the 0 placeholder (exact under
                        # the caller's score >= smin filter)
                        rows, sc = decode_screen_words(seg, b)
                        out[item_idx][chunk_idx[rows]] = sc
                    else:
                        out[item_idx][chunk_idx] = seg[: len(chunk_idx)]
                pos += g_pad * w
            return out

        return fetch

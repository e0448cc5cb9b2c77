"""End-to-end SIFT4G pipeline orchestration.

Mirrors the reference main() phase order (main.cpp:188-250):
check queries -> prefilter search -> alignment with E-value filter ->
(optional sub-results) -> entropy selection -> SIFT predictions.

The alignment phase mirrors sift4g's alignDatabase
(database_alignment.cpp:21-127): the database is re-streamed in chunks,
each query aligns against the candidates present in the chunk (consuming
its ascending index list), alignments are E-value-filtered, capped at
``max_alignments`` best-first, and merged across chunks.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .align.batch import BatchAligner, PackedTargets, _targets_total_len, align_pairs_batch
from .align.records import AlignmentRecord
from .core.chain import Chain
from .core.evalue import EValueParams, create_evalue_params, evalues
from .core.scorers import Scorer, create_scorer
from .io.fasta import ChunkStore, FastaStream, read_fasta
from .io.subst import check_data
from .io.writers import (
    create_file_name,
    write_alignments_report,
    write_selected_alignments,
)
from .prefilter.search import search_database
from .sift.predict import predict_query
from .sift.select import alignments_select, extract_alignment_strings

from .utils import PhaseMetrics, query_log

ALIGN_CHUNK_BYTES = 1_000_000_000  # database_alignment.cpp:12


def _query_fanout(fn, n: int, threads: int, log) -> None:
    """One task per query on a host thread pool (the analogue of
    the reference's threadPoolSubmit fan-out, select_alignments.cpp:55-65 /
    sift_prediction.cpp:152-162).  NumPy releases the GIL in the hot math,
    so threads give real parallelism; per-query outputs are independent."""
    if threads <= 1 or n <= 1:
        for qi in range(n):
            fn(qi)
            query_log(qi + 1, n, log=log)
        return
    from concurrent.futures import ThreadPoolExecutor

    done = 0
    with ThreadPoolExecutor(max_workers=min(threads, n)) as ex:
        for _ in ex.map(fn, range(n)):
            done += 1
            query_log(done, n, log=log)


@dataclass
class PipelineConfig:
    query_path: str = ""
    database_path: str = ""
    kmer_length: int = 5
    max_candidates: int = 5000
    gap_open: int = 10
    gap_extend: int = 1
    matrix: str = "BLOSUM_62"
    max_alignments: int = 400
    max_evalue: float = 0.0001
    algorithm: str = "SW"
    median_threshold: float = 2.75
    subst_path: str = ""
    out_path: str = ""
    sub_results: bool = False
    out_format: str = "bm9"
    sequence_identity: int = 100
    align_backend: str = "auto"
    predict_backend: str = "host"
    search_chunk_bytes: int = 250_000_000
    align_chunk_bytes: int = ALIGN_CHUNK_BYTES
    log: object = field(default_factory=lambda: sys.stderr)
    timings: bool = False
    threads: int = 8  # host fan-out over queries (reference -t, main.cpp:85)
    # overlap the host prefilter with provisional device scoring:
    # "auto" = when an accelerator + the parse cache + the native engine are
    # all present; "on" forces it (CPU tests); "off" keeps the reference's
    # strict two-phase order (main.cpp:204-218)
    overlap: str = "auto"
    # process only queries [lo, hi) of the query FASTA (multi-host query
    # sharding; applied BEFORE subst validation so the partition is
    # deterministic across hosts)
    query_range: Optional[tuple] = None
    # device-resident database scoring: "auto" | "on" | "off"
    # (align_database docstring)
    resident_db: str = "auto"
    # multi-host partitioning axis: "db" (shard the database, merge
    # candidates/winners — the few-queries x huge-db mode) or "queries"
    # (each host owns a contiguous query slice end to end — the
    # missense/proteome mode, no cross-host merges)
    multihost_shard: str = "db"
    # crash recovery for proteome-scale runs: skip queries whose
    # .SIFTprediction already exists in out_path.  Queries are
    # independent end to end (per-query candidate sets; E-value params
    # depend only on database size), so the remaining outputs are
    # byte-identical to a full run's.  Queries that legitimately produce
    # NO output (zero E-value survivors) are re-processed every resume —
    # cheap and harmless.  Incompatible with --sub-results (the global
    # alignments.txt would cover only the resumed subset).
    resume: bool = False
    # local device indices for alignment (reference --cards); None = all
    cards: Optional[tuple] = None
    # caller-provided PhaseMetrics (benchmark harnesses read the phase
    # table back after the run; None = pipeline-internal)
    metrics: Optional[object] = None


def align_database(
    database_path: str,
    queries: List[Chain],
    indices: List[np.ndarray],
    scorer: Scorer,
    evalue_params: EValueParams,
    max_evalue: float,
    max_alignments: int,
    mode: str = "SW",
    backend: str = "auto",
    chunk_bytes: int = ALIGN_CHUNK_BYTES,
    log=sys.stderr,
    metrics: Optional[PhaseMetrics] = None,
    record_range=None,
    resident_db: str = "auto",
    threads: int = 0,
    cards: Optional[tuple] = None,
) -> List[List[AlignmentRecord]]:
    """Returns per-query alignment records, best-first (score desc,
    database index asc on ties — deterministic refinement of the
    reference's unstable ordering, quirk Q4).

    ``record_range=(lo, hi)``: multi-host shard — streams only that record
    slice; the caller passes candidate ``indices`` already restricted to
    the shard (ids stay global).

    ``resident_db``: "auto" | "on" | "off" — device-resident scoring
    (upload the database codes once; launches ship offset/length arrays
    instead of target bytes).  "auto" enables it when the pallas grouped
    path is active on an accelerator, the parse cache is present, and the
    candidate byte volume exceeds the one-time upload."""
    print("** Aligning queries with candidate sequences **", file=log)
    aligner = BatchAligner(
        scorer, mode=mode, backend=backend, threads=threads, cards=cards
    )

    results: List[List[AlignmentRecord]] = [[] for _ in queries]
    remaining = [list(ix) for ix in indices]

    # per-query integer passing-score thresholds: exact inverse of the
    # E-value filter (core/evalue.min_passing_score), used both for
    # device-side screening (fetch survivors only)
    # and the host keep filter (integer compare replaces the dense
    # E-value pass; same set by construction)
    from .core.evalue import min_passing_score

    if os.environ.get("SIFT4G_TPU_SCREEN", "1") == "0":   # control knob
        smin_all = [None for _ in queries]
    else:
        smin_all = [
            min_passing_score(max_evalue, len(q), evalue_params)
            for q in queries
        ]

    store = ChunkStore(start=record_range[0] if record_range else 0)
    with FastaStream(database_path, record_range=record_range) as fs:
        resident = None
        if resident_db != "off":
            resident = _maybe_resident_db(
                fs, indices, aligner, resident_db, log, record_range
            )
            aligner.resident = resident
        rr_lo = record_range[0] if record_range else 0
        cache_offsets = getattr(fs, "_offsets", None)
        more, codes0, offsets0, names0 = fs.read_part_arrays(chunk_bytes)
        store.append_part(codes0, offsets0, names0)
        while True:
            db_end = store.count - 1
            # slices of a heap-backed part (no parse cache) pin the whole
            # part; kept records must copy their target codes so the part
            # can be evicted at the end of the iteration
            consumed_is_mmap = store.latest_is_mmap
            # slice every query's candidates for this chunk, then score them
            # all with ONE device round trip (the fetch closure defers it)
            chunk_used: List[List[int]] = [[] for _ in queries]
            score_items = []
            active = []
            for qi, query in enumerate(queries):
                cand = remaining[qi]
                take = 0
                while take < len(cand) and cand[take] <= db_end:
                    take += 1
                if take == 0:
                    continue
                chunk_used[qi] = cand[:take]
                remaining[qi] = cand[take:]
                if resident is not None:
                    ids = np.asarray(chunk_used[qi], dtype=np.int64)
                    lens_q = (
                        cache_offsets[ids + 1] - cache_offsets[ids]
                    ).astype(np.int32)
                    # resident layout is shard-local under record_range
                    targets = resident.packed_targets(ids - rr_lo, lens_q)
                else:
                    packed = store.pack_latest(chunk_used[qi])
                    if packed is not None:
                        targets = PackedTargets(*packed)
                    else:  # defensive: indices outside the newest part
                        targets = [store.codes(t) for t in chunk_used[qi]]
                score_items.append((query.codes, targets))
                active.append(qi)
                if metrics is not None:
                    metrics.add(
                        "align",
                        cells=float(len(query)) * float(_targets_total_len(targets)),
                    )
            import time as _time

            t_disp = _time.perf_counter()
            fetch = aligner.scores_many_async(
                score_items,
                screen=([smin_all[qi] for qi in active], max_alignments),
            )
            if metrics is not None:
                metrics.add("align.dispatch", seconds=_time.perf_counter() - t_disp)
            # overlap: stream the next database part while the device scores
            next_more = more
            if more:
                import threading

                result = {}

                def _read():
                    result["part"] = fs.read_part_arrays(chunk_bytes)

                reader = threading.Thread(target=_read)
                reader.start()
            t_fetch = _time.perf_counter()
            all_scores = fetch()
            if metrics is not None:
                metrics.add("align.fetch", seconds=_time.perf_counter() - t_fetch)
            if more:
                reader.join()
                next_more, codes_n, offsets_n, names_n = result["part"]
                store.append_part(codes_n, offsets_n, names_n)
            t_keep = _time.perf_counter()
            for qi, scores in zip(active, all_scores):
                query = queries[qi]
                used = chunk_used[qi]
                smin_q = smin_all[qi]
                if smin_q is not None and smin_q >= 1:
                    # integer threshold == the evalues() filter set by
                    # construction; also correct when the aligner screened
                    # (non-survivors come back 0 < smin_q)
                    keep = np.flatnonzero(scores >= smin_q)
                else:
                    evals_full = evalues(scores, len(query), evalue_params)
                    keep = np.flatnonzero(evals_full <= max_evalue)
                # best-first: score desc, db index asc
                keep = sorted(keep.tolist(), key=lambda i: (-int(scores[i]), used[i]))
                keep = keep[:max_alignments]
                evals_kept = evalues(
                    scores[np.asarray(keep, dtype=np.int64)],
                    len(query), evalue_params,
                )
                recs = align_pairs_batch(
                    query.codes,
                    [store.codes(used[i]) for i in keep],
                    scorer,
                    mode,
                    threads=threads,
                )
                for i, rec, ev in zip(keep, recs, evals_kept):
                    rec.target_idx = used[i]
                    rec.target_name = store.name(used[i])
                    rec.evalue = float(ev)
                    if not consumed_is_mmap:
                        rec.target_codes = np.array(rec.target_codes, copy=True)
                    results[qi].append(rec)
                if len(results[qi]) > max_alignments:
                    results[qi].sort(key=lambda r: (-r.score, r.target_idx))
                    del results[qi][max_alignments:]
            if metrics is not None:
                metrics.add("align.traceback", seconds=_time.perf_counter() - t_keep)
            # evict consumed parts: mmap-backed parts cost nothing either
            # way, heap-backed parts would otherwise grow RSS to the full
            # database size (kept records copied their codes above)
            store.drop_before_latest()
            if not more:
                break  # the chunk just processed was the last
            more = next_more
    # final best-first order across chunks
    for qi in range(len(queries)):
        results[qi].sort(key=lambda r: (-r.score, r.target_idx))
        del results[qi][max_alignments:]
    return results


def _overlap_cache(cfg: PipelineConfig, n_queries: int = 1):
    """The parse-cache handle when the overlapped pipeline can run, else
    None.  Requirements: the native search engine (chunk callbacks), the
    .s4gc cache (mmap random access for the end-of-run traceback), and —
    under "auto" — an actual accelerator (on CPU the overlap is pure
    extra work: provisionally scored candidates may be evicted later).

    Memory bound: the overlapped pipeline holds a
    provisional score per LIVE candidate, so its floor is
    n_queries * max_candidates dict entries (~100 B each).  When that
    exceeds SIFT4G_TPU_OVERLAP_PROV_BUDGET entries (default 20M ~ 2 GB)
    the overlap refuses — loudly under ``overlap=on`` — and the pipeline
    falls back to the two-phase order, which streams candidates
    chunk-by-chunk instead.  Accrual BEYOND the live set (admitted then
    evicted ids) is bounded separately by snapshot compaction inside
    _run_overlapped."""
    if cfg.overlap == "off":
        return None
    live_entries = n_queries * max(cfg.max_candidates, 1)
    budget = int(
        os.environ.get("SIFT4G_TPU_OVERLAP_PROV_BUDGET", str(20_000_000))
    )
    if live_entries > budget:
        if cfg.overlap == "on":
            print(
                f"* WARNING: --overlap on refused: {n_queries} queries x "
                f"{cfg.max_candidates} candidates = {live_entries} "
                f"provisional entries exceeds the {budget}-entry budget "
                f"(SIFT4G_TPU_OVERLAP_PROV_BUDGET); running two-phase *",
                file=cfg.log,
            )
        return None
    from . import native
    from .io.fasta import CachedFastaStream

    if native.load() is None:
        return None
    if cfg.overlap == "auto":
        # the overlapped scan scores chunk slabs; an explicit resident
        # database request keeps the two-phase path that uses it
        if cfg.align_backend == "numpy" or cfg.resident_db == "on":
            return None
        # Overlap costs roughly a core of host work while the scan runs
        # (launch packing, dispatch and fetch resolution), which a small
        # host cannot spare: auto enables it only when cores are
        # plentiful relative to the scan's scaling.  Count effectively
        # AVAILABLE cores (affinity/cgroup-aware), not installed ones.
        try:
            n_cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            n_cores = os.cpu_count() or 1
        if n_cores < 8:
            return None
        import jax

        if jax.devices()[0].platform == "cpu":
            return None
    try:
        fs = FastaStream(cfg.database_path)
    except Exception:
        return None
    if isinstance(fs, CachedFastaStream):
        return fs
    fs.close()
    return None


def _run_overlapped(
    cfg: PipelineConfig,
    queries: List[Chain],
    scorer: Scorer,
    cache,
    metrics: PhaseMetrics,
) -> List[List[AlignmentRecord]]:
    """Prefilter + provisional device scoring overlapped.

    Exactness argument: a database sequence enters the engine's top-k only
    while its own chunk is current (the admission floor is monotone and
    never falls, quirk Q3), so the union of per-chunk snapshots is a
    superset of the final candidate set; provisional scores of later-
    evicted ids are simply dropped.  Kept scores are bit-identical to the
    two-phase path's because the same BatchAligner computes them, and the
    final (E-value filter, score desc/id asc truncate) runs once globally
    — the same set the per-chunk truncate + merge produces."""
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    log = cfg.log
    aligner = BatchAligner(
        scorer, mode=cfg.algorithm, backend=cfg.align_backend,
        threads=cfg.threads, cards=cfg.cards,
    )
    prov: List[dict] = [dict() for _ in queries]
    # Resolving fetches inside the chunk callback would stall the native
    # scan while the device finishes.  A single resolve worker keeps the
    # scan free: the C++ scan holds no GIL and the fetch waits on the
    # device, so they truly overlap.  One worker => resolves stay ordered
    # and the prov dict needs no lock (read only after shutdown).
    resolver = ThreadPoolExecutor(max_workers=1)
    resolves: List = []

    def _resolve_one(fetch, meta):
        t0 = _time.perf_counter()
        all_scores = fetch()
        metrics.add("align.fetch", seconds=_time.perf_counter() - t0)
        for (qi, ids), scores in zip(meta, all_scores):
            d = prov[qi]
            for t, s in zip(ids.tolist(), scores.tolist()):
                d[t] = s

    # Admitted-then-evicted ids accrue in prov across chunks; at many-query
    # scale that can dwarf the live candidate set.  Compaction drops keys
    # absent from the engine's snapshot — EXACT because each database
    # record is scanned once and the admission floor is monotone (Q3), so
    # an evicted id can never re-enter.  Runs on the single resolver
    # worker: FIFO order guarantees it sees prov after exactly the
    # resolves submitted before it (same snapshot chunk).
    prov_live_cap = int(os.environ.get(
        "SIFT4G_TPU_OVERLAP_COMPACT_CAP",
        str(max(1_000_000, 2 * len(queries) * max(cfg.max_candidates, 1))),
    ))

    def _compact(ids_now):
        if sum(len(d) for d in prov) <= prov_live_cap:
            return
        for qi, cur in enumerate(ids_now):
            d = prov[qi]
            if len(d) > cur.size:
                prov[qi] = {int(t): d[int(t)] for t in cur}

    def on_chunk(codes, offsets, names, start_idx, snapshot):
        ids_now = snapshot()
        offs = np.asarray(offsets, dtype=np.int64)
        items, meta = [], []
        for qi, query in enumerate(queries):
            cur = ids_now[qi]
            new = cur[cur >= start_idx]  # this chunk's admissions (ids asc)
            if new.size == 0:
                continue
            local = new - start_idx
            starts = offs[local]
            lens = (offs[local + 1] - starts).astype(np.int32)
            items.append((query.codes, PackedTargets(codes, starts, lens)))
            meta.append((qi, new))
            metrics.add(
                "align", cells=float(len(query)) * float(int(lens.sum()))
            )
        if items:
            t0 = _time.perf_counter()
            fetch = aligner.scores_many_async(items)
            metrics.add("align.dispatch", seconds=_time.perf_counter() - t0)
            resolves.append(resolver.submit(_resolve_one, fetch, meta))
            # tracked like resolves so a compaction error propagates
            resolves.append(resolver.submit(_compact, ids_now))
        # drain finished resolves (surfaces a device error at the next
        # chunk instead of hours later) and bound the in-flight backlog —
        # each pending resolve pins a chunk's device results, so block on
        # the oldest rather than queue without limit when fetches lag
        # bound counts fetch AND compact futures (two per chunk)
        while resolves and (resolves[0].done() or len(resolves) > 4):
            resolves.pop(0).result()

    try:
        with metrics.phase("search"):
            indices, cells = search_database(
                cfg.database_path,
                queries,
                kmer_length=cfg.kmer_length,
                max_candidates=cfg.max_candidates,
                chunk_bytes=cfg.search_chunk_bytes,
                log=log,
                threads=cfg.threads,
                on_chunk=on_chunk,
            )
            for fut in resolves:
                fut.result()  # propagate fetch errors; all scores landed
    finally:
        resolver.shutdown(wait=True)
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)))

    evalue_params = create_evalue_params(cells, scorer, log=log)
    print("** Aligning queries with candidate sequences **", file=log)
    results: List[List[AlignmentRecord]] = [[] for _ in queries]
    with metrics.phase("align"):
        for qi, query in enumerate(queries):
            ids = indices[qi]
            if ids.size == 0:
                continue
            scores = np.fromiter(
                (prov[qi][int(t)] for t in ids), dtype=np.int64, count=ids.size
            )
            evals = evalues(scores, len(query), evalue_params)
            keep = np.flatnonzero(evals <= cfg.max_evalue)
            keep = sorted(
                keep.tolist(), key=lambda i: (-int(scores[i]), int(ids[i]))
            )
            keep = keep[: cfg.max_alignments]
            recs = align_pairs_batch(
                query.codes,
                [cache.codes_at(int(ids[i])) for i in keep],
                scorer,
                cfg.algorithm,
                threads=cfg.threads,
            )
            for i, rec in zip(keep, recs):
                rec.target_idx = int(ids[i])
                rec.target_name = cache.name_at(int(ids[i]))
                rec.evalue = float(evals[i])
                results[qi].append(rec)
    return results


def _maybe_resident_db(fs, indices, aligner, mode_flag: str, log,
                       record_range=None):
    """Build (or fetch the cached) device-resident database when it pays.

    Under a multi-host ``record_range`` shard only THAT slice of the
    database is uploaded (each host holds its own shard; candidate ids
    stay global — the caller translates by the shard base).

    Requirements (any miss -> None, slab path): the grouped launch path
    (backend pallas; single-device or mesh — under a mesh the segments
    replicate across devices and launches shard the group axis,
    parallel/sharded.make_grouped_resident_sharded), the parse cache
    (absolute offsets + mmap codes), and a database no larger than a
    quarter of the device's memory (utils.device_memory_bytes; the rest
    holds launch working sets and device prediction).  Under "auto"
    additionally: a real accelerator, and total candidate bytes exceeding
    the database size (the one-time upload must beat the slab traffic it
    replaces)."""
    from .align.batch import ResidentDB, get_resident_db
    from .io.fasta import CachedFastaStream
    from .utils import device_memory_bytes

    if not isinstance(fs, CachedFastaStream):
        return None
    if aligner.backend != "pallas":
        return None
    rr_lo = record_range[0] if record_range else 0
    offsets = fs._offsets
    if record_range is not None:
        # absolute offsets of the shard's records only
        offsets = offsets[record_range[0] : record_range[1] + 1]
    db_bytes = int(offsets[-1] - offsets[0])
    n_segs = max(-(-db_bytes // ResidentDB.SEG_CAP), 1)
    limit = device_memory_bytes()
    if limit is None:
        print("* resident database refused: the device reports no memory "
              "size *", file=log)
        return None
    if n_segs * ResidentDB.DEV_GRAIN + db_bytes > limit // 4:
        return None
    if mode_flag == "auto":
        import jax

        from .align.batch import resident_db_cached

        if jax.devices()[0].platform == "cpu":
            return None
        # a live upload is sunk cost (serve-daemon jobs, warm repeats):
        # reuse it regardless of this job's candidate volume
        if not resident_db_cached(fs._codes, offsets, aligner._mesh):
            cand_bytes = 0
            for ix in indices:
                ix = np.asarray(ix, dtype=np.int64) - rr_lo  # shard-local
                if ix.size:
                    cand_bytes += int((offsets[ix + 1] - offsets[ix]).sum())
            if cand_bytes <= db_bytes:
                return None
    try:
        rdb = get_resident_db(fs._codes, offsets, aligner._mesh)
    except Exception as exc:  # upload failure: keep the slab path
        print(f"* resident database unavailable ({exc}) *", file=log)
        return None
    print(
        f"** Align phase uses the device-resident database "
        f"({rdb.nbytes / 1e9:.2f} GB) **",
        file=log,
    )
    return rdb


_MANIFEST_NAME = ".sift4g_tpu_run.json"
# the parameters that change .SIFTprediction bytes for a given query —
# resuming with any of these differing would silently mix outputs from
# two distinct runs (advisor r4: resume matches on filename only)
_MANIFEST_KEYS = (
    "query_path", "database_path", "kmer_length", "max_candidates",
    "gap_open", "gap_extend", "matrix", "max_alignments", "max_evalue",
    "algorithm", "median_threshold", "subst_path", "sequence_identity",
)


def _manifest_params(cfg: PipelineConfig) -> dict:
    return {
        k: os.path.abspath(v) if k.endswith("_path") and v else v
        for k, v in ((k, getattr(cfg, k)) for k in _MANIFEST_KEYS)
    }


def _write_run_manifest(cfg: PipelineConfig) -> None:
    """Record the output-affecting parameters in --out (best-effort)."""
    import json

    path = os.path.join(cfg.out_path, _MANIFEST_NAME)
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fp:
            json.dump(_manifest_params(cfg), fp, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def _resume_check_manifest(cfg: PipelineConfig, log) -> None:
    """Warn when --resume reuses an --out directory whose recorded run
    parameters differ from this invocation's (outputs would silently mix
    two different runs).  Warn-not-fail: the manifest is advisory and
    absent for pre-manifest output directories."""
    import json

    path = os.path.join(cfg.out_path, _MANIFEST_NAME)
    try:
        with open(path) as fp:
            prev = json.load(fp)
    except (OSError, ValueError):
        return
    now = _manifest_params(cfg)
    diffs = [
        f"{k}: {prev[k]!r} -> {now[k]!r}"
        for k in _MANIFEST_KEYS
        if k in prev and prev[k] != now[k]
    ]
    if diffs:
        print(
            "* WARNING: --resume with parameters differing from the run "
            "that produced this --out directory; existing predictions "
            "were made with: " + "; ".join(diffs) + " *",
            file=log,
        )


def run_pipeline(cfg: PipelineConfig) -> List[Chain]:
    """Run the full pipeline; returns the list of processed queries."""
    log = cfg.log
    metrics = cfg.metrics or PhaseMetrics(log=log, enabled=cfg.timings)
    queries = read_fasta(cfg.query_path)
    if cfg.query_range is not None:
        lo, hi = cfg.query_range
        queries = queries[lo:hi]
    print("** Checking query data and substitutions files **", file=log)
    queries = check_data(queries, cfg.subst_path, log=log)
    if cfg.resume and cfg.out_path:
        _resume_check_manifest(cfg, log)
        # outputs are written via atomic tmp+os.replace (io/writers.py
        # atomic_output), so an existing .SIFTprediction is always a
        # COMPLETE one; a crash leaves only *.tmp.<pid>.<seq> strays,
        # swept here so they cannot accumulate across resumes.  Only
        # strays older than a grace window are removed: a CONCURRENT
        # sibling process sharing --out (query-sharded multi-host) may be
        # mid-write, and its live temp files are seconds old while a
        # crashed run's strays are as old as the crash
        import glob
        import time as _time

        grace_s = 300.0
        now = _time.time()
        for stray in glob.glob(
            os.path.join(glob.escape(cfg.out_path), "*.tmp.*")
        ):
            try:
                if now - os.path.getmtime(stray) > grace_s:
                    os.unlink(stray)
            except OSError:
                pass
        done = [
            q for q in queries
            if os.path.exists(
                create_file_name(q.name, cfg.out_path, ".SIFTprediction"))
        ]
        if done:
            print(f"** Resume: skipping {len(done)} queries with existing "
                  f"predictions **", file=log)
            done_names = {q.name for q in done}
            queries = [q for q in queries if q.name not in done_names]
    if cfg.out_path:
        _write_run_manifest(cfg)
    if not queries:
        print("** EXITING! No valid queries to process. **", file=log)
        return []

    cache = _overlap_cache(cfg, len(queries))
    if cache is not None:
        scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
        records = _run_overlapped(cfg, queries, scorer, cache, metrics)
        finish_pipeline(cfg, queries, records, metrics)
        return queries

    with metrics.phase("search"):
        indices, cells = search_database(
            cfg.database_path,
            queries,
            kmer_length=cfg.kmer_length,
            max_candidates=cfg.max_candidates,
            chunk_bytes=cfg.search_chunk_bytes,
            log=log,
            threads=cfg.threads,
        )
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)))

    scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
    evalue_params = create_evalue_params(cells, scorer, log=log)

    with metrics.phase("align"):
        records = align_database(
            cfg.database_path,
            queries,
            indices,
            scorer,
            evalue_params,
            cfg.max_evalue,
            cfg.max_alignments,
            mode=cfg.algorithm,
            backend=cfg.align_backend,
            chunk_bytes=cfg.align_chunk_bytes,
            log=log,
            metrics=metrics,
            resident_db=cfg.resident_db,
            threads=cfg.threads,
            cards=cfg.cards,
        )

    finish_pipeline(cfg, queries, records, metrics)
    return queries


def finish_pipeline(
    cfg: PipelineConfig,
    queries: List[Chain],
    records: List[List[AlignmentRecord]],
    metrics: Optional[PhaseMetrics] = None,
) -> None:
    """Post-align stages: sub-results, selection, prediction, reports.

    Shared by the single-process pipeline and the multi-host harness
    (host 0 only — reference single-process output semantics)."""
    log = cfg.log
    if metrics is None:
        metrics = PhaseMetrics(log=log, enabled=cfg.timings)
    if cfg.sub_results:
        path = create_file_name("alignments", cfg.out_path, ".txt")
        write_alignments_report(
            records, queries, path, cfg.out_format,
            scorer=create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend),
        )

    print(
        f"** Selecting alignments with median threshold: {cfg.median_threshold:.2f} **",
        file=log,
    )
    all_names: List[List[str]] = [None] * len(queries)
    all_rows: List[np.ndarray] = [None] * len(queries)

    def _select_one(qi: int) -> None:
        names, rows = extract_alignment_strings(queries[qi], records[qi])
        if rows.shape[0]:
            n_sel = alignments_select(rows, cfg.median_threshold)
            names, rows = names[:n_sel], rows[:n_sel]
        all_names[qi] = names
        all_rows[qi] = rows

    with metrics.phase("select"):
        _query_fanout(_select_one, len(queries), cfg.threads, log)

    if cfg.sub_results:
        strings = [
            [Chain.from_string(nm, (row + ord("A")).tobytes().decode("ascii"))
             for nm, row in zip(all_names[qi], all_rows[qi])]
            for qi in range(len(queries))
        ]
        write_selected_alignments(strings, queries, cfg.out_path)

    print(
        f"** Generating SIFT predictions with sequence identity: "
        f"{float(cfg.sequence_identity):.2f}% **",
        file=log,
    )
    # under --predict-backend device ALL queries ride the batched device
    # launches: matrix-mode queries get the float32 full-matrix write
    # (documented non-bit-parity, sift/predict_batch.py), subst-mode
    # queries get the f32-screen + sparse-float64-exact hybrid whose
    # outputs are byte-identical to the host oracle's
    # (sift/predict_subst.py)
    device_qis: List[int] = []
    subst_paths = {}
    if cfg.predict_backend == "device":
        from .io.subst import subst_file_name
        from .sift.predict_batch import max_device_query_len

        max_qlen = max_device_query_len()
        for qi in range(len(queries)):
            if not all_rows[qi].shape[0]:
                continue
            # query lengths whose (n_pad, L_pad, 26) one-hot intermediate
            # would not fit the device's predict budget stay on the host
            # oracle (predict_batch.max_device_query_len)
            if len(queries[qi]) > max_qlen:
                continue
            device_qis.append(qi)
            sp = subst_file_name(queries[qi].name, cfg.subst_path)
            if os.path.isfile(sp):
                subst_paths[qi] = sp
    device_set = set(device_qis)

    def _predict_one(qi: int) -> None:
        if all_rows[qi].shape[0] == 0 or qi in device_set:
            return  # sift_prediction.cpp:154
        predict_query(
            queries[qi],
            all_names[qi],
            all_rows[qi],
            cfg.subst_path,
            cfg.sequence_identity,
            cfg.out_path,
        )

    with metrics.phase("predict"):
        _query_fanout(_predict_one, len(queries), cfg.threads, log)
        if device_qis:
            from .sift.predict import prepare_rows
            from .sift.predict_batch import predict_matrix_batch

            # row prep (Q7 cap + identity filter + vstack) is independent
            # per query and NumPy-heavy — fan it over the host threads like
            # the reference's per-query prediction tasks
            # (sift_prediction.cpp:144-171)
            import time as _time

            t_prep = _time.perf_counter()
            if cfg.threads > 1 and len(device_qis) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                    prepared = list(ex.map(
                        lambda qi: prepare_rows(
                            queries[qi], all_names[qi], all_rows[qi],
                            cfg.sequence_identity,
                        ),
                        device_qis,
                    ))
            else:
                prepared = [
                    prepare_rows(
                        queries[qi], all_names[qi], all_rows[qi],
                        cfg.sequence_identity,
                    )
                    for qi in device_qis
                ]
            metrics.add("predict.prep", seconds=_time.perf_counter() - t_prep)
            finishers = None
            subst_exec, subst_futs = None, []
            if subst_paths:
                from .io.subst import read_subst_lines
                from .sift.predict_subst import (
                    finish_subst_query,
                    finish_subst_task,
                    make_subst_executor,
                )

                # at proteome query counts the finishers' GIL-held numpy
                # share serializes the writer THREAD pool; a small spawn
                # process pool scales them (predict_subst docstrings)
                subst_exec = make_subst_executor(len(subst_paths))
                finishers = [None] * len(device_qis)
                for k, qi in enumerate(device_qis):
                    sp = subst_paths.get(qi)
                    if sp is None:
                        continue
                    args = (
                        queries[qi], prepared[k], read_subst_lines(sp),
                        create_file_name(
                            queries[qi].name, cfg.out_path, ".SIFTprediction"
                        ),
                    )
                    if subst_exec is not None:
                        finishers[k] = (
                            lambda scores, a=args: subst_futs.append(
                                subst_exec.submit(
                                    finish_subst_task,
                                    (a[0].name, a[0].letters, a[1], a[2],
                                     np.ascontiguousarray(scores), a[3]),
                                )
                            )
                        )
                    else:
                        finishers[k] = (
                            lambda scores, a=args:
                            finish_subst_query(a[0], a[1], a[2], scores,
                                               a[3], log=log)
                        )
            try:
                predict_matrix_batch(
                    [queries[qi] for qi in device_qis], prepared,
                    cfg.out_path, threads=cfg.threads, metrics=metrics,
                    finishers=finishers,
                )
                t_drain = _time.perf_counter()
                for fut in subst_futs:
                    fut.result()  # surface worker exceptions
                if subst_futs:
                    metrics.add(
                        "predict.substdrain",
                        seconds=_time.perf_counter() - t_drain,
                    )
            finally:
                if subst_exec is not None:
                    subst_exec.shutdown()
    metrics.report()

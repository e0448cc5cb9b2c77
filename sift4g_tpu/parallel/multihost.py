"""Multi-host execution harness (BASELINE configs 3-5; docs/MULTIHOST.md).

The reference is a single process; its closest analogue is the pthread
fan-out over database ranges with a host-side top-k merge
(reference database_search.cpp:101-154).  The multi-host mapping:

* one process per host, joined with ``jax.distributed.initialize`` (Gloo
  collectives on CPU test meshes, the accelerator's own transport on
  real hosts);
* the database is split into record-aligned, residue-balanced contiguous
  shards; host ``h`` streams ONLY its shard (free seek through the .s4gc
  parse cache) with global record indices;
* prefilter: per-host top-``max_candidates`` lists carry (score, id);
  a single O(hosts * k) exchange merges them under the same
  (score desc, id asc) total order the single-process truncate uses —
  candidate sets are therefore byte-identical to one process
  (quirk Q3/Q4 refinement, database_search.cpp:131-154);
* align: each host aligns the merged candidates that live in its shard
  (it owns those codes) on its LOCAL chip mesh; the per-query
  ``max_alignments`` winner merge is another O(hosts * k) exchange of
  serialized records (mirror of dbAlignmentsMerge,
  reference database_alignment.cpp:97-104);
* selection / prediction / reports run on host 0 only (the reference's
  single-process output semantics).

Determinism: every merge uses the total order (score desc, db index asc),
so outputs are independent of the host count — the same property the
thread-count-independence tests assert for the native prefilter.
"""

from __future__ import annotations

import os
import pickle
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.evalue import create_evalue_params
from ..core.scorers import create_scorer
from ..io.fasta import CachedFastaStream, FastaStream
from ..io.subst import check_data
from ..prefilter.search import search_database
from ..utils import PhaseMetrics


@dataclass
class HostContext:
    process_id: int
    num_processes: int

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def init_distributed_from_env() -> Optional[HostContext]:
    """Join the multi-host job described by SIFT4G_COORDINATOR /
    SIFT4G_NUM_PROCESSES / SIFT4G_PROCESS_ID; None when not configured.

    Must run before any JAX device use.  On CPU platforms the Gloo
    cross-process collective backend is selected (the virtual test mesh);
    accelerators use their own transport.
    """
    coord = os.environ.get("SIFT4G_COORDINATOR")
    if not coord:
        return None
    nproc = int(os.environ.get("SIFT4G_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("SIFT4G_PROCESS_ID", "0"))
    if nproc <= 1:
        return None
    import jax

    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # option renamed/absent: accelerator transports need none
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    return HostContext(pid, nproc)


def allgather_bytes(payload: bytes, n_processes: int) -> List[bytes]:
    """Gather one byte string from every process (length exchange + padded
    uint8 all-gather over the global mesh).  Doubles as a barrier."""
    from jax.experimental import multihost_utils

    ln = np.array([len(payload)], dtype=np.int64)
    lens = np.asarray(multihost_utils.process_allgather(ln)).reshape(-1)
    cap = max(int(lens.max()), 1)
    buf = np.zeros(cap, dtype=np.uint8)
    if payload:
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    gathered = gathered.reshape(n_processes, cap)
    return [gathered[i, : int(lens[i])].tobytes() for i in range(n_processes)]


def shard_record_ranges(database_path: str, n_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous record-index shards, residue-balanced via the parse
    cache's offsets (record-count-balanced on the cache-less fallback).
    Deterministic: every host computes identical ranges."""
    fs = FastaStream(database_path)
    try:
        if isinstance(fs, CachedFastaStream):
            offsets = fs._offsets
            nrec = offsets.shape[0] - 1
            total = int(offsets[-1])
            bounds = [0]
            for h in range(1, n_hosts):
                b = int(np.searchsorted(offsets, total * h // n_hosts))
                bounds.append(min(max(b, bounds[-1]), nrec))
            bounds.append(nrec)
        else:
            nrec = 0
            more = True
            while more:
                more, _codes, offs, _names = fs.read_part_arrays(1 << 28)
                nrec += offs.shape[0] - 1
            bounds = [nrec * h // n_hosts for h in range(n_hosts + 1)]
    finally:
        fs.close()
    return [(bounds[h], bounds[h + 1]) for h in range(n_hosts)]


def _merge_candidates(per_host_scored, n_queries: int, max_candidates: int):
    """Global top-k from per-shard top-k lists under (score desc, id asc) —
    identical to the single-process truncate order (_TopK.truncate /
    native search.cpp cand_less)."""
    indices = []
    for qi in range(n_queries):
        scores = np.concatenate([h[qi][0] for h in per_host_scored])
        ids = np.concatenate([h[qi][1] for h in per_host_scored])
        order = np.lexsort((ids, -scores))
        keep = order[:max_candidates]
        indices.append(np.sort(ids[keep]))
    return indices


def _run_queries_sharded(cfg, ctx: HostContext):
    """Query-sharded multi-host: host ``h`` owns the contiguous query slice
    [n*h/H, n*(h+1)/H) of the query FASTA and runs the UNSHARDED pipeline
    on it (full database scan per host).

    This is the missense/proteome mode (thousands of matrix-mode queries):
    per-query outputs are independent files, so there are no cross-host
    merges and outputs are trivially byte-identical to a single process.
    Each host writes its own queries' files (the reference writes one file
    per query, sift_prediction.cpp:220-234); a final barrier makes "done"
    mean every host's files exist.  Prefer this axis when queries are
    plentiful — the per-host k-mer table covers only its query slice, and
    prefilter hit work (the many-query cost driver, ROADMAP) divides by
    the host count; shard the database instead when queries are few.
    """
    from ..io.fasta import read_fasta
    from ..pipeline import run_pipeline
    from dataclasses import replace

    n = len(read_fasta(cfg.query_path))
    lo = n * ctx.process_id // ctx.num_processes
    hi = n * (ctx.process_id + 1) // ctx.num_processes
    log = cfg.log
    print(
        f"** Multi-host (query-sharded): {ctx.num_processes} hosts; this is "
        f"host {ctx.process_id} with queries [{lo}, {hi}) of {n} **",
        file=log,
    )
    sub = replace(cfg, query_range=(lo, hi))
    queries = run_pipeline(sub)
    allgather_bytes(b"done", ctx.num_processes)  # barrier: all files on disk
    return queries


def run_pipeline_multihost(cfg, ctx: HostContext):
    """Distributed twin of pipeline.run_pipeline; host 0 writes all output."""
    from ..io.fasta import read_fasta
    from ..pipeline import align_database, finish_pipeline

    if getattr(cfg, "multihost_shard", "db") == "queries":
        return _run_queries_sharded(cfg, ctx)

    log = cfg.log if ctx.is_primary else open(os.devnull, "w")
    metrics = PhaseMetrics(log=log, enabled=cfg.timings and ctx.is_primary)
    queries = read_fasta(cfg.query_path)
    print("** Checking query data and substitutions files **", file=log)
    queries = check_data(queries, cfg.subst_path, log=log)
    if not queries:
        print("** EXITING! No valid queries to process. **", file=log)
        return []

    ranges = shard_record_ranges(cfg.database_path, ctx.num_processes)
    lo, hi = ranges[ctx.process_id]
    print(
        f"** Multi-host: {ctx.num_processes} hosts; this is host "
        f"{ctx.process_id} with database records [{lo}, {hi}) **",
        file=log,
    )

    with metrics.phase("search"):
        _idx, cells_local, scored = search_database(
            cfg.database_path,
            queries,
            kmer_length=cfg.kmer_length,
            max_candidates=cfg.max_candidates,
            chunk_bytes=cfg.search_chunk_bytes,
            log=log,
            threads=cfg.threads,
            record_range=(lo, hi),
            return_scored=True,
        )
        # O(hosts * k) candidate exchange + global merge (every host
        # computes the same sets — needed to slice its own shard's work)
        parts = allgather_bytes(
            pickle.dumps((cells_local, scored), protocol=4), ctx.num_processes
        )
        cells = 0
        per_host_scored = []
        for p in parts:
            c, s = pickle.loads(p)
            cells += c
            per_host_scored.append(s)
        indices = _merge_candidates(per_host_scored, len(queries), cfg.max_candidates)
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)))

    scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
    evalue_params = create_evalue_params(cells, scorer, log=log)

    local_indices = [ix[(ix >= lo) & (ix < hi)] for ix in indices]
    with metrics.phase("align"):
        records_local = align_database(
            cfg.database_path,
            queries,
            local_indices,
            scorer,
            evalue_params,
            cfg.max_evalue,
            cfg.max_alignments,
            mode=cfg.algorithm,
            backend=cfg.align_backend,
            chunk_bytes=cfg.align_chunk_bytes,
            log=log,
            metrics=metrics,
            record_range=(lo, hi),
            threads=cfg.threads,
            cards=cfg.cards,
        )
        # winner merge: mirror of dbAlignmentsMerge
        # (database_alignment.cpp:97-104) across hosts
        parts = allgather_bytes(
            pickle.dumps(records_local, protocol=4), ctx.num_processes
        )

    if not ctx.is_primary:
        return queries

    records = [[] for _ in queries]
    for p in parts:
        for qi, lst in enumerate(pickle.loads(p)):
            records[qi].extend(lst)
    for qi in range(len(queries)):
        records[qi].sort(key=lambda r: (-r.score, r.target_idx))
        del records[qi][cfg.max_alignments :]

    finish_pipeline(cfg, queries, records, metrics)
    return queries

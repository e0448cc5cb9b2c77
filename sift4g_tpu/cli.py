"""Command-line interface.

Mirrors the reference's 19-flag getopt surface (main.cpp:21-42, defaults at
:68-91, validation at :163-186), plus device extras (--backend,
--platform, --serve).  --cards selects local devices exactly like the
reference's digit-list parser (main.cpp:254-262) and restricts the
alignment mesh to them; -t drives the host fan-out and the native engines.
"""

from __future__ import annotations

import argparse
import os
import sys

from .pipeline import PipelineConfig, run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift4g-tpu",
        description="SIFT4G on JAX: predicts whether amino-acid substitutions "
        "are TOLERATED or DELETERIOUS.",
    )
    p.add_argument("-q", "--query", required=True,
                   help="input fasta query file, or a directory of .fa/.fasta "
                   "files processed sequentially in one warm process "
                   "(amortizes kernel compiles across jobs)")
    p.add_argument("-d", "--database", required=True, help="input fasta database file")
    p.add_argument("-g", "--gap-open", type=int, default=10,
                   help="gap opening penalty (default: 10)")
    p.add_argument("-e", "--gap-extend", type=int, default=1,
                   help="gap extension penalty (default: 1; must be <= gap-open)")
    p.add_argument("--matrix", default="BLOSUM_62",
                   help="similarity matrix: BLOSUM_30/45/50/62/70/80/90/250 "
                   "(default: BLOSUM_62; BLOSUM_250 is the published PAM250 "
                   "table — no BLOSUM250 exists in the literature)")
    p.add_argument("--evalue", type=float, default=0.0001,
                   help="evalue threshold; higher-evalue alignments are filtered")
    p.add_argument("--max-aligns", type=int, default=400,
                   help="maximum number of alignments (default: 400)")
    p.add_argument("--algorithm", default="SW", choices=["SW", "NW", "HW", "OV"],
                   help="alignment algorithm (default: SW)")
    p.add_argument("--out", default="", help="output directory for SIFT predictions")
    p.add_argument("--sub-results", action="store_true",
                   help="write alignment file and per-query selected alignments")
    p.add_argument("--outfmt", default="bm9", choices=["bm0", "bm8", "bm9", "light"],
                   help="alignment file format (default: bm9)")
    p.add_argument("--kmer-length", type=int, default=5,
                   help="k-mer length for database search: 3, 4 or 5 (default: 5)")
    p.add_argument("--max-candidates", type=int, default=5000,
                   help="sequences forwarded to the alignment phase (default: 5000)")
    p.add_argument("--median-threshold", type=float, default=2.75,
                   help="alignment diversity threshold (default: 2.75)")
    p.add_argument("--subst", default="",
                   help="directory containing per-query .subst files")
    p.add_argument("--seq-id", type=int, default=100,
                   help="drop alignments this %% identical to the query (default: 100)")
    p.add_argument("-t", "--threads", type=int, default=8,
                   help="host threads for per-query selection/prediction fan-out (default: 8)")
    p.add_argument("--cards", default="",
                   help="accelerator cards used for alignment, as a digit "
                   "string exactly like the reference (e.g. '02' = local "
                   "devices 0 and 2; main.cpp:254-262). Default: ALL local "
                   "devices — a deliberate divergence from the reference, "
                   "whose no-cards default is CPU-only (quirk Q10)")
    # device extras
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "numpy", "pallas", "native"],
                   help="alignment scoring backend (default: auto — the "
                   "Pallas-Triton GPU kernel ('pallas') on a GPU, the "
                   "threaded C++ aligner ('native') on a CPU host, the "
                   "plain XLA scan ('xla') elsewhere)")
    p.add_argument("--predict-backend", default="host", choices=["host", "device"],
                   help="prediction math: host (float64 oracle, bit-parity "
                   "default) or device (batched float32 launches for "
                   "proteome-scale query counts). Under device, matrix-mode "
                   "files are float32 (last printed decimal may differ on "
                   "rounding boundaries) while substitution-mode files stay "
                   "BYTE-IDENTICAL to the host oracle (f32 screen + exact "
                   "float64 at every printed/threshold position)")
    p.add_argument("--timings", action="store_true",
                   help="print per-phase wall-clock and throughput counters")
    p.add_argument("--cache-dir", default="",
                   help="directory for the binary FASTA parse caches "
                   "(default: next to each input file). Use for read-only "
                   "or shared database directories; cache filenames hash "
                   "the input path+size+mtime so databases never collide. "
                   "Equivalent to SIFT4G_TPU_CACHE_DIR")
    p.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                   help="overlap the prefilter scan with device scoring "
                   "(default: auto — on when an accelerator, the parse "
                   "cache, the native engine and >= 8 host cores are all "
                   "present and --resident-db is not 'on'; launch packing "
                   "and dispatch cost about a core while the scan runs)")
    p.add_argument("--resident-db", default="auto",
                   choices=["auto", "on", "off"],
                   help="device-resident database scoring: upload the "
                   "codes once, ship only offset/length arrays per launch "
                   "(auto: when the pallas path is active and candidate "
                   "bytes exceed the one-time upload)")
    p.add_argument("--resume", action="store_true",
                   help="skip queries whose .SIFTprediction already exists "
                   "in --out (crash recovery for proteome-scale runs; "
                   "remaining outputs are byte-identical to a full run). "
                   "Queries that legitimately produce no output re-run. "
                   "Requires the SAME -q/-d/--subst and scoring parameters "
                   "as the interrupted run (a mismatch vs the recorded run "
                   "manifest in --out warns). Incompatible with "
                   "--sub-results")
    p.add_argument("--mh-shard", default="db", choices=["db", "queries"],
                   help="multi-host partition axis: shard the database "
                   "(merge candidates/winners; few queries x huge db) or "
                   "shard the queries (each host owns a slice end to end; "
                   "the many-query missense mode)")
    p.add_argument("--serve", default="", metavar="SOCKET",
                   help="run as a long-lived daemon on this UNIX socket, "
                   "owning the device and keeping compiled kernels and the "
                   "resident database warm across jobs")
    p.add_argument("--connect", default="", metavar="SOCKET",
                   help="submit this invocation to a --serve daemon "
                   "instead of running locally")
    p.add_argument("--shutdown", action="store_true",
                   help="with --connect: stop the daemon and exit")
    p.add_argument("--platform", default="auto",
                   help="JAX platform to target: cpu or gpu (default: "
                   "JAX's own choice); set via jax.config before any "
                   "device is initialized")
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    return p


def _flag_value(argv, flag):
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return ""


def main(argv=None) -> int:
    raw_argv = list(sys.argv[1:] if argv is None else argv)

    # daemon/client modes run before full parsing: -q/-d are required for a
    # pipeline run but a daemon starts without a job, and a client defers
    # validation to the daemon
    serve_sock = _flag_value(raw_argv, "--serve")
    if serve_sock:
        from .serve import serve_forever

        return serve_forever(serve_sock, _flag_value(raw_argv, "--platform") or "auto")
    connect_sock = _flag_value(raw_argv, "--connect")
    if connect_sock:
        from .serve import _strip_flag, submit

        if "--shutdown" in raw_argv:
            return submit(connect_sock, [], shutdown=True)
        return submit(connect_sock, _strip_flag(raw_argv, "--connect"))

    args = build_parser().parse_args(argv)

    def fail(msg: str) -> int:
        print(f"error: {msg}", file=sys.stderr)
        return -1

    if args.shutdown:
        return fail("--shutdown requires --connect SOCKET")

    if args.cache_dir:
        if not os.path.isdir(args.cache_dir):
            try:
                os.makedirs(args.cache_dir, exist_ok=True)
            except OSError as exc:
                return fail(f"cannot create cache directory "
                            f"'{args.cache_dir}': {exc}")
        os.environ["SIFT4G_TPU_CACHE_DIR"] = args.cache_dir

    if args.platform != "auto":
        try:
            import jax

            jax.config.update("jax_platforms", args.platform)
        except Exception as exc:
            return fail(f"cannot select platform '{args.platform}': {exc}")
    from .utils import enable_compile_cache

    enable_compile_cache()

    # multi-host job? (SIFT4G_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID)
    from .parallel.multihost import init_distributed_from_env

    host_ctx = init_distributed_from_env()

    if os.path.isdir(args.query):
        query_files = sorted(
            os.path.join(args.query, f)
            for f in os.listdir(args.query)
            if f.endswith((".fa", ".fasta")) and not f.endswith(".s4gc")
        )
        if not query_files:
            return fail(f"no .fa/.fasta files in directory '{args.query}'")
    elif os.path.isfile(args.query):
        query_files = [args.query]
    else:
        return fail(f"invalid query file path '{args.query}'")
    if not os.path.isfile(args.database):
        return fail(f"invalid database file path '{args.database}'")
    if not (2 < args.kmer_length < 6):
        return fail("kmer_length possible values = 3,4,5")
    if args.max_candidates <= 0:
        return fail("invalid max candidates number")
    if args.evalue <= 0:
        return fail("invalid evalue")
    if args.max_aligns <= 0:
        return fail("invalid max alignments number")
    if args.threads <= 0:
        return fail("invalid thread number")
    # digit-by-digit card list, exactly like the reference's getCudaCards
    # (main.cpp:254-262); range validation happens at mesh construction
    # where the device count is known
    if args.cards and not args.cards.isdigit():
        return fail(f"invalid cards list '{args.cards}' (digits only, e.g. '02')")
    if args.out and not os.path.isdir(args.out):
        return fail(f"invalid out directory path '{args.out}'")
    if args.resume and args.sub_results:
        return fail("--resume is incompatible with --sub-results (the "
                    "global alignments.txt would cover only the resumed "
                    "subset)")
    if args.subst and not os.path.isdir(args.subst):
        return fail(f"invalid substitutions directory path '{args.subst}'")
    # validate matrix + gap penalties up front, before any heavy phase runs
    from .core.scorers import create_scorer

    try:
        create_scorer(args.matrix, args.gap_open, args.gap_extend)
    except ValueError as exc:
        return fail(str(exc))

    for query_path in query_files:
        if len(query_files) > 1:
            print(f"** Processing query file: {query_path} **", file=sys.stderr)
        _run_one(args, query_path, host_ctx)
    return 0


def _run_one(args, query_path: str, host_ctx=None) -> None:
    cfg = PipelineConfig(
        query_path=query_path,
        database_path=args.database,
        kmer_length=args.kmer_length,
        max_candidates=args.max_candidates,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend,
        matrix=args.matrix,
        max_alignments=args.max_aligns,
        max_evalue=args.evalue,
        algorithm=args.algorithm,
        median_threshold=args.median_threshold,
        subst_path=args.subst,
        out_path=args.out,
        sub_results=args.sub_results,
        resume=args.resume,
        out_format=args.outfmt,
        sequence_identity=args.seq_id,
        align_backend=args.backend,
        predict_backend=args.predict_backend,
        timings=args.timings,
        threads=args.threads,
        overlap=args.overlap,
        resident_db=args.resident_db,
        multihost_shard=args.mh_shard,
        cards=tuple(int(c) for c in args.cards) if args.cards else None,
    )
    if host_ctx is not None:
        from .parallel.multihost import run_pipeline_multihost

        run_pipeline_multihost(cfg, host_ctx)
    else:
        run_pipeline(cfg)


if __name__ == "__main__":
    sys.exit(main())

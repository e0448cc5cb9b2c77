"""End-to-end pipeline benchmark on a synthetic database.

Usage:
  python tools/make_synthetic_db.py /tmp/synth --n-db 20000 --n-q 10
  python tools/bench_pipeline.py /tmp/synth [--backend auto] [--max-candidates 5000]

Prints per-phase timings (PhaseMetrics) and a queries/sec summary line.

Variance protocol: single-run totals at proteome scale can swing with
host load while individual phases stay honest — so A/Bs at that scale
aggregate PHASE-LEVEL BEST-OF across runs.  Mechanics:

  # each arm, N times:            (appends one JSON line per run)
  python tools/bench_pipeline.py /tmp/synth --repeat --json runs_armA.jsonl
  # one-command composite:
  python tools/bench_pipeline.py --aggregate runs_armA.jsonl [runs_armB.jsonl ...]

--aggregate prints, per input file, the best-of-phases composite over its
WARM runs (each top-level phase's minimum across runs, summed) next to
the best single-run total — mechanically comparable arms.
"""

import argparse
import json
import os
import sys
import time

# self-locating: works as a bare subprocess from any cwd even when the
# package is not installed in the venv
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def aggregate(paths):
    """Per input file: phase-level best-of composite over its warm runs
    (the honest multi-run aggregate at proteome scale) + best single-run
    total.  One summary line per file, one comparison table overall."""
    for path in paths:
        runs = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    runs.append(json.loads(line))
        warm = [r for r in runs if not r.get("tag", "").startswith("cold")]
        pool = warm or runs
        if not pool:
            print(f"{path}: no runs", file=sys.stderr)
            continue
        # subst-mode predict is a different computation — pool per mode
        by_mode = {}
        for r in pool:
            mode = "subst" if "subst" in r.get("tag", "") else "matrix"
            by_mode.setdefault(mode, []).append(r)
        for mode, mpool in sorted(by_mode.items()):
            # top-level phases only (align.fetch etc. nest inside)
            best = {}
            for r in mpool:
                for name, d in r.get("phases", {}).items():
                    if "." in name:
                        continue
                    s = d.get("seconds", 0.0)
                    if name not in best or s < best[name]:
                        best[name] = s
            composite = sum(best.values())
            best_total = min(r["total_s"] for r in mpool)
            q = mpool[0].get("queries", 0)
            phase_str = " ".join(f"{k}={v:.1f}" for k, v in sorted(best.items()))
            print(
                f"{path} [{mode}]: {len(mpool)} warm runs | "
                f"composite(best-of-phases) {composite:.1f}s "
                f"({q / composite:.1f} q/s) | best single run "
                f"{best_total:.1f}s | {phase_str}"
            )
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir", nargs="?")
    ap.add_argument("--aggregate", nargs="+", metavar="RUNS_JSONL",
                    help="aggregate mode: phase-level best-of composite "
                    "per runs file (no benchmark is executed)")
    ap.add_argument("--json", default="",
                    help="append one JSON line per run (tag, total_s, "
                    "queries, phases) to this file — feeds --aggregate")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--max-candidates", type=int, default=5000)
    ap.add_argument("--out", default="")
    ap.add_argument("--repeat", action="store_true",
                    help="run twice; the second (warm) run excludes kernel compiles")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU platform (jax.config, pre-backend-init)")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                    help="prefilter/align overlap mode (A/B knob)")
    ap.add_argument("--predict-backend", default="host",
                    choices=["host", "device"],
                    help="matrix-mode prediction path (device = bucketed "
                    "vmapped scores, the many-query missense mode)")
    ap.add_argument("--subst", default="",
                    help="substitutions directory (subst-mode benchmark — "
                    "the reference's product mode; see make_synthetic_db "
                    "--subst-per-query)")
    ap.add_argument("--also-subst", default="", metavar="DIR",
                    help="after the scheduled runs, run two more WARM "
                    "passes with --subst DIR in the same process (shares "
                    "the compile pass: matrix vs subst A/B in one session)")
    ap.add_argument("--resident-db", default="auto",
                    choices=["auto", "on", "off"],
                    help="device-resident database scoring (A/B knob)")
    ap.add_argument("--overlap-ab", action="store_true",
                    help="cold + three warm runs A/B-ing overlap on/off in "
                    "one process (one compile pass)")
    args = ap.parse_args()

    if args.aggregate:
        sys.exit(aggregate(args.aggregate))
    if not args.data_dir:
        ap.error("data_dir is required unless --aggregate is given")

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline
    from sift4g_tpu.utils import PhaseMetrics, enable_compile_cache

    enable_compile_cache()

    out_dir = args.out or os.path.join(args.data_dir, "out")
    os.makedirs(out_dir, exist_ok=True)
    cfg = PipelineConfig(
        query_path=os.path.join(args.data_dir, "queries.fa"),
        database_path=os.path.join(args.data_dir, "db.fa"),
        out_path=out_dir,
        align_backend=args.backend,
        max_candidates=args.max_candidates,
        subst_path=args.subst,
        timings=True,
        overlap=args.overlap,
        predict_backend=args.predict_backend,
        resident_db=args.resident_db,
    )
    if args.overlap_ab:
        # one process, one compile pass: cold(on) then warm A/B runs —
        # overlap on/off reuse identical kernel shapes; arms INTERLEAVE so
        # drift hits both equally
        schedule = [("cold", "on"), ("warm-off", "off"), ("warm-on", "on"),
                    ("warm-off2", "off"), ("warm-on2", "on")]
    else:
        tags = ["cold", "warm"] if args.repeat else ["cold"]
        schedule = [(t, args.overlap) for t in tags]
    if args.also_subst:
        schedule += [("subst-warm1", args.overlap), ("subst-warm2", args.overlap)]
    for tag, ov in schedule:
        cfg.subst_path = args.also_subst if tag.startswith("subst") else args.subst
        cfg.overlap = ov
        cfg.metrics = PhaseMetrics(log=sys.stderr, enabled=True)
        t0 = time.perf_counter()
        queries = run_pipeline(cfg)
        dt = time.perf_counter() - t0
        print(
            f"pipeline[{tag}]: {len(queries)} queries in {dt:.2f}s "
            f"-> {len(queries) / dt:.3f} queries/s "
            f"[backend={args.backend} overlap={ov}]",
            file=sys.stderr,
        )
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(json.dumps({
                    "tag": tag,
                    "total_s": round(dt, 3),
                    "queries": len(queries),
                    "backend": args.backend,
                    "phases": cfg.metrics.phases,
                }) + "\n")


if __name__ == "__main__":
    main()

"""End-to-end proof that the SIFT 4G pipeline runs on an NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the 4-card sharded path only

Phases (any failure exits non-zero and prints no result):

1. Device: JAX's platform must be ``gpu``; prints the card's name and
   power limit (nvidia-smi) and the JAX version.
2. Kernel parity at real widths: the compiled grouped kernel against the
   native AVX2 scorer, exact int32, in all four modes, two scorers, the
   bench shape, every length rung up to 4096, a Titin-class target, an
   8k-aa query, the resident (offset) variant and the fused E-value
   screen; a sample against the NumPy DP oracle; compile and warm times of
   the kernel and of the plain XLA scan at the bench shape; the peak
   memory of compiled prediction launches (XLA's memory analysis on the
   card) against the estimate the device-predict limits come from.
3. End to end through ``sift4g_tpu.cli`` on a Swiss-Prot-scale database
   generated from a seed (570,000 sequences, ~199 M residues, 256 queries):
   ``--backend auto --cards 0 --resident-db on`` in subst and matrix mode
   must equal ``--backend native`` on the host byte for byte; device
   prediction in subst mode too; matrix-mode device prediction reports its
   float32 drift against the float64 oracle beside its bound.  An 8,192-aa
   and a 35,000-aa query go through device prediction in subst mode and
   must equal host prediction byte for byte.
4. Served path: a ``--serve`` daemon on the card answers two ``--connect``
   jobs whose outputs must equal phase 3's.  The daemon's first job (a new
   process) must add no entry to the persistent compile cache: every
   executable it needs was stored by phase 3.  Its ``align.dispatch`` time
   is printed beside phase 3's cold one.

``--four-cards`` runs phase 3's workload with ``--cards 0123`` (slab and
resident sharded launches) against the host-native outputs, and nothing
else.

One process uses the card at a time: this parent never imports JAX; a
worker process runs phases 1-3, then the daemon runs phase 4.  Generated
data and outputs live in ``.chip_smoke/`` inside the checkout.  The last
stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
DATA = os.path.join(WORK, "data")
OUT = os.path.join(WORK, "out")
REPORT = os.path.join(WORK, "report.json")
LONG = os.path.join(WORK, "long")

N_DB = 570_000          # Swiss-Prot scale (~199 M residues at mean 350 aa)
N_QUERIES = 256
SUBST_PER_QUERY = 5
# phase 2 workload: (G, B, N, m) launch shapes, the length rungs checked,
# the long target/query, and the resident database
SIZES = dict(
    bench=(64, 1024, 512, 360),
    modes=(8, 1024, 512, 360),
    rungs=[128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096],
    rung_targets=300,
    titin=35_000,
    long_query=8192,
    resident_seqs=20_000,
    resident_queries=8,
    resident_cands=2_000,
    # device-predict launches whose compiled peak memory is read
    predict_mem=[(1, 448, 35_072), (1, 448, 8_192), (64, 448, 384)],
)
# queries sent through device prediction beyond the synthetic lengths
LONG_QUERIES = {"LONG_8K": 8_192, "LONG_35K": 35_000}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


def cli_argv(out, *, subst, backend, extra=(), qdir=DATA):
    argv = ["-q", os.path.join(qdir, "queries.fa"),
            "-d", os.path.join(DATA, "db.fa"),
            "--out", out, "--backend", backend, "--timings",
            "-t", str(os.cpu_count() or 8)]
    if subst:
        argv += ["--subst", qdir]
    return argv + list(extra)


def cache_dir() -> str:
    """The persistent compile cache the program uses (utils.enable_compile_cache)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(ROOT, ".jax_cache")


def cache_entries() -> int:
    try:
        return sum(n.endswith("-cache") for n in os.listdir(cache_dir()))
    except OSError:
        return 0


_DISPATCH = re.compile(r"align\.dispatch\s+([\d.]+)s")


def dispatch_seconds(text: str) -> float:
    """The ``align.dispatch`` seconds of a --timings report."""
    m = _DISPATCH.findall(text)
    if not m:
        raise AssertionError("no align.dispatch line in the job's timings")
    return float(m[-1])


def compare_dirs(a: str, b: str) -> int:
    """Byte-compare the .SIFTprediction files of two output dirs; returns
    the file count (raises on any difference)."""
    names_a = sorted(f for f in os.listdir(a) if f.endswith(".SIFTprediction"))
    names_b = sorted(f for f in os.listdir(b) if f.endswith(".SIFTprediction"))
    if names_a != names_b:
        raise AssertionError(
            f"{a} vs {b}: file sets differ ({len(names_a)} vs {len(names_b)})")
    if not names_a:
        raise AssertionError(f"{a}: no .SIFTprediction files")
    for n in names_a:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{n} differs between {a} and {b}")
    return len(names_a)


_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")


def printed_drift(a: str, b: str) -> float:
    """Largest difference between the printed numbers of matching files."""
    worst = 0.0
    for n in sorted(os.listdir(a)):
        if not n.endswith(".SIFTprediction"):
            continue
        with open(os.path.join(a, n)) as fa, open(os.path.join(b, n)) as fb:
            xa = [float(x) for x in _NUM.findall(fa.read())]
            xb = [float(x) for x in _NUM.findall(fb.read())]
        if len(xa) != len(xb):
            raise AssertionError(f"{n}: value counts differ")
        worst = max([worst] + [abs(p - q) for p, q in zip(xa, xb)])
    return worst


# ---------------------------------------------------------------- phase 2

def phase_kernel(report: dict) -> None:
    import numpy as np
    import jax.numpy as jnp

    import bench
    from sift4g_tpu import native
    from sift4g_tpu.align.batch import (
        BatchAligner, ResidentDB, score_pairs_batch,
    )
    from sift4g_tpu.align.dp_numpy import score_pair
    from sift4g_tpu.align.pallas_sw import PAD_CODE, sw_scores_pallas_grouped
    from sift4g_tpu.align.xla import _extend_matrix, align_scores_grouped_kernel
    from sift4g_tpu.core.scorers import create_scorer

    if native.load() is None:
        raise RuntimeError("the native scorer did not build")
    rng = np.random.default_rng(7)
    checked = {"cells": 0, "pairs": 0}

    def native_ref(q, targets, scorer, mode):
        return score_pairs_batch(q, targets, scorer, mode).astype(np.int64)

    def check(name, got, want):
        got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
        if got.shape != want.shape or not (got == want).all():
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"kernel parity failed: {name} ({bad} differ)")
        checked["pairs"] += int(got.size)
        log(f"  parity ok: {name} ({got.size} pairs)")

    def grouped(G, B, N, m, scorer, mode, full=False):
        m_pad = -(-m // 64) * 64
        q = np.full(G * m_pad, PAD_CODE, np.int32)
        qcodes = [rng.integers(0, 26, m).astype(np.uint8) for _ in range(G)]
        for g in range(G):
            q[g * m_pad : g * m_pad + m] = qcodes[g]
        tg = rng.integers(0, 26, (G, B, N)).astype(np.int8)
        tl = (np.full((G, B), N, np.int32) if full
              else rng.integers(1, N + 1, (G, B)).astype(np.int32))
        qo = (np.arange(G) * m_pad).astype(np.int32)
        ql = np.full(G, m, np.int32)
        got = np.asarray(sw_scores_pallas_grouped(
            q, qo, ql, tg, tl, _extend_matrix(scorer.matrix), mode=mode,
            gap_open=scorer.gap_open, gap_extend=scorer.gap_extend))
        want = np.stack([
            native_ref(qcodes[g], [tg[g, b, : tl[g, b]].view(np.uint8)
                                   for b in range(B)], scorer, mode)
            for g in range(G)
        ])
        checked["cells"] += int(m) * int(tl.sum())
        return got, want, qcodes, tg, tl

    b62 = create_scorer("BLOSUM_62", 10, 1)
    b45 = create_scorer("BLOSUM_45", 12, 2)

    # bench shape, SW: every pair against the native scorer, a sample
    # against the NumPy oracle
    G, B, N, m = SIZES["bench"]
    got, want, qcodes, tg, tl = grouped(G, B, N, m, b62, "SW")
    check(f"bench shape G={G} B={B} N={N} m={m} SW BLOSUM62 10/1", got, want)
    for g, b in [(0, 0), (1, 3), (G - 1, B - 1), (G // 2, B // 2)]:
        ref = score_pair(qcodes[g], tg[g, b, : tl[g, b]].view(np.uint8), b62, "SW")
        if got[g, b] != ref:
            raise AssertionError(f"kernel != dp_numpy at group {g} row {b}")
    log("  parity ok: 4 sampled pairs == dp_numpy")

    for scorer, sname in ((b62, "BLOSUM62 10/1"), (b45, "BLOSUM45 12/2")):
        for mode in ("SW", "NW", "HW", "OV"):
            G, B, N, m = SIZES["modes"]
            got, want, *_ = grouped(G, B, N, m, scorer, mode)
            check(f"{mode} {sname} G={G} B={B} N={N}", got, want)

    # the launch policy at every length rung up to 4096, a Titin-class
    # target, an 8k-aa query: BatchAligner on the card
    al = BatchAligner(b62, backend="pallas")
    assert al._mesh is None and al.grouped_impl == "pallas"
    q350 = rng.integers(0, 26, 350).astype(np.uint8)
    lo = 1
    for r in SIZES["rungs"]:
        targets = [rng.integers(0, 26, int(n)).astype(np.uint8)
                   for n in rng.integers(lo, r + 1, SIZES["rung_targets"])]
        check(f"rung {r} (lengths {lo}..{r})", al.scores(q350, targets),
              native_ref(q350, targets, b62, "SW"))
        checked["cells"] += 350 * sum(len(t) for t in targets)
        lo = r + 1
    n_titin = SIZES["titin"]
    titin = rng.integers(0, 26, n_titin).astype(np.uint8)
    titin[n_titin // 2 : n_titin // 2 + 350] = q350
    targets = [titin, rng.integers(0, 26, 400).astype(np.uint8)]
    got = al.scores(q350, targets)
    check(f"Titin-class {n_titin}-aa target", got,
          native_ref(q350, targets, b62, "SW"))
    assert got[0] > 1000
    n_long = SIZES["long_query"]
    q_long = rng.integers(0, 26, n_long).astype(np.uint8)
    targets = [rng.integers(0, 26, int(n)).astype(np.uint8)
               for n in rng.integers(100, 600, 300)]
    targets[7] = q_long[n_long // 2 - 200 : n_long // 2 + 200].copy()
    got = al.scores(q_long, targets)
    check(f"{n_long}-aa query", got, native_ref(q_long, targets, b62, "SW"))
    assert got[7] > 1000

    # resident (offset) variant + the fused E-value screen
    n_seqs = SIZES["resident_seqs"]
    lens = np.clip(rng.normal(350, 100, n_seqs), 30, 3000).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(db, offsets)
    alr = BatchAligner(b62, backend="pallas", resident=rdb)
    items, refs = [], []
    for _ in range(SIZES["resident_queries"]):
        q = rng.integers(0, 26, int(rng.integers(100, 900))).astype(np.uint8)
        ids = np.sort(rng.choice(n_seqs, SIZES["resident_cands"], replace=False))
        items.append((q, rdb.packed_targets(ids, lens[ids].astype(np.int32))))
        refs.append(native_ref(q, [db[offsets[i] : offsets[i + 1]] for i in ids],
                               b62, "SW"))
    launches = alr.launches
    for i, got in enumerate(alr.scores_many(items)):
        check(f"resident query {i}", got, refs[i])
    assert alr.launches > launches
    smins = [int(np.percentile(r, 99)) for r in refs]
    dense = alr.scores_many_async(items, screen=(smins, 400))()
    for i, got in enumerate(dense):
        check(f"screened resident query {i}", got,
              np.where(refs[i] >= smins[i], refs[i], 0))

    # compile + warm time: kernel vs plain XLA scan at the bench shape
    G, B, N, m = SIZES["bench"]
    q_all, q_off, q_lens, m_pad = bench._inputs(rng, G, B, N, m)
    qa, qo, ql = jnp.asarray(q_all), jnp.asarray(q_off), jnp.asarray(q_lens)
    lens_full = jnp.asarray(np.full((G, B), N, np.int32))
    m32 = jnp.asarray(_extend_matrix(b62.matrix))
    slabs = [jnp.asarray(rng.integers(0, 26, (G, B, N)).astype(np.int8))
             for _ in range(3)]
    cells = G * B * N * m
    # true compile times: fresh in-memory caches, persistent cache off
    import jax

    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", False)
    kc, kw, kout = bench.time_fn(
        lambda t: sw_scores_pallas_grouped(qa, qo, ql, t, lens_full, m32), slabs)
    xc, xw, xout = bench.time_fn(
        lambda t: align_scores_grouped_kernel(qa, qo, ql, t, lens_full, m32,
                                              m_window=m_pad), slabs)
    jax.config.update("jax_enable_compilation_cache", True)
    check("bench shape kernel == XLA scan", kout, xout)
    card = card_line()
    log(f"  timing on {card}: kernel compile {kc:.3f} s, warm {kw * 1e3:.3f} ms "
        f"({cells / kw / 1e9:.1f} GCUPS); XLA scan compile {xc:.3f} s, warm "
        f"{xw * 1e3:.3f} ms ({cells / xw / 1e9:.1f} GCUPS)")
    report["kernel"] = {
        "card": card, "pairs_checked": checked["pairs"],
        "predict_peak_ratio": phase_predict_memory(),
        "kernel_compile_s": kc, "kernel_warm_s": kw,
        "xla_compile_s": xc, "xla_warm_s": xw,
        "kernel_gcups": cells / kw / 1e9, "xla_gcups": cells / xw / 1e9,
    }


def phase_predict_memory() -> float:
    """Compiled peak of device-predict launches on the card, as a multiple
    of their one-hot volume, against PEAK_PER_ONEHOT."""
    from sift4g_tpu.sift import predict_batch as pb

    worst = 0.0
    for q, n_pad, l_pad in SIZES["predict_mem"]:
        r = pb.compiled_peak_ratio(q, n_pad, l_pad)
        log(f"  predict launch ({q}, {n_pad}, {l_pad}): compiled peak "
            f"{r:.3f} x its one-hot volume")
        worst = max(worst, r)
    log(f"  PEAK_PER_ONEHOT = {pb.PEAK_PER_ONEHOT}; longest device-predict "
        f"query {pb.max_device_query_len()} aa")
    if worst > pb.PEAK_PER_ONEHOT:
        raise AssertionError("a predict launch peaks above PEAK_PER_ONEHOT")
    return worst


def predict_drift() -> float:
    """Largest |f32 device - f64 host| SIFT score on alignment-like rows
    (mutated copies of random queries), over every matrix cell."""
    import numpy as np
    import jax.numpy as jnp

    from sift4g_tpu.sift.scores import calc_sift_scores, create_matrix
    from sift4g_tpu.sift.scores_jax import sift_scores_from_rows_batch

    rng = np.random.default_rng(11)
    Q, n, L = 8, 256, 384
    rows = np.empty((Q, n, L), np.int8)
    worst = 0.0
    host = []
    aas = np.array([ord(c) - 65 for c in "ACDEFGHIKLMNPQRSTVWY"])
    for k in range(Q):
        q = rng.choice(aas, L)
        r = np.repeat(q[None], n, axis=0)
        mut = rng.random((n, L)) < rng.uniform(0.05, 0.6, (n, 1))
        r[mut] = rng.choice(aas, int(mut.sum()))
        gaps = rng.random((n, L)) < 0.05
        r[gaps] = ord("X") - 65
        r[0] = q
        rows[k] = r
        raw, _ = create_matrix(r.astype(np.int64), np.ones(n))
        host.append(calc_sift_scores(r.astype(np.int64), raw)[0])
    dev = np.asarray(sift_scores_from_rows_batch(
        jnp.asarray(rows), jnp.full(Q, n, jnp.int32)))
    for k in range(Q):
        worst = max(worst, float(np.abs(dev[k].astype(np.float64) - host[k]).max()))
    return worst


# ---------------------------------------------------------------- phase 3

def make_data() -> None:
    if os.path.exists(os.path.join(DATA, "db.fa")):
        return
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_db.py"),
         DATA, "--n-db", str(N_DB), "--n-q", str(N_QUERIES),
         "--subst-per-query", str(SUBST_PER_QUERY), "--seed", "0"],
        check=True,
    )
    from sift4g_tpu.io.fasta import build_fasta_cache

    for f in ("db.fa", "queries.fa"):
        build_fasta_cache(os.path.join(DATA, f))
    log(f"  data generated in {time.perf_counter() - t0:.1f} s")


def start_native(label: str, subst: bool):
    """A host-native reference run in a CPU-only child process."""
    out = os.path.join(OUT, label)
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    argv = [sys.executable, "-m", "sift4g_tpu"] + cli_argv(
        out, subst=subst, backend="native", extra=["--platform", "cpu"])
    logf = open(os.path.join(OUT, label + ".log"), "w")
    return out, subprocess.Popen(argv, env=env, cwd=ROOT, stdout=logf,
                                 stderr=subprocess.STDOUT)


def wait_native(proc, label: str, timeout: float) -> None:
    if proc.wait(timeout=timeout) != 0:
        with open(os.path.join(OUT, label + ".log")) as fh:
            sys.stderr.write(fh.read()[-4000:])
        raise RuntimeError(f"host-native run {label} failed")


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)
        return len(s)

    def flush(self):
        for f in self.streams:
            f.flush()


def gpu_run(label: str, subst: bool, extra, qdir=DATA):
    """One in-process CLI run on the card; (output dir, its stderr)."""
    from sift4g_tpu.cli import main as cli_main

    out = os.path.join(OUT, label)
    os.makedirs(out, exist_ok=True)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, err)):
        rc = cli_main(cli_argv(out, subst=subst, backend="auto", extra=extra,
                               qdir=qdir))
    if rc != 0:
        raise RuntimeError(f"CLI run {label} exited {rc}")
    log(f"  {label}: {time.perf_counter() - t0:.1f} s")
    return out, err.getvalue()


def make_long_queries() -> None:
    """LONG_QUERIES built from the synthetic queries laid end to end (so
    the database holds homologs of their pieces), each with a .subst."""
    import numpy as np

    from sift4g_tpu.io.fasta import read_fasta

    chains = read_fasta(os.path.join(DATA, "queries.fa"))
    pool = "".join(c.letters for c in chains)
    os.makedirs(LONG, exist_ok=True)
    rng = np.random.default_rng(3)
    with open(os.path.join(LONG, "queries.fa"), "w") as fh:
        for name, n in LONG_QUERIES.items():
            seq = (pool * (n // len(pool) + 1))[:n]
            fh.write(f">{name}\n{seq}\n")
            with open(os.path.join(LONG, name + ".subst"), "w") as sf:
                for p in np.sort(rng.choice(n, 5, replace=False)):
                    new = "W" if seq[p] != "W" else "A"
                    sf.write(f"{seq[p]}{p + 1}{new}\n")


def phase_e2e(report: dict, cards: str) -> None:
    from sift4g_tpu.sift.predict_subst import EPS_SCREEN

    make_data()
    nat_s, p_s = start_native("native_subst", True)
    nat_m, p_m = start_native("native_matrix", False)
    base = ["--cards", cards]
    runs = {}
    res = base + ["--resident-db", "on"]
    dev = ["--predict-backend", "device"]
    if cards == "0":
        runs["gpu_subst"], err = gpu_run("gpu_subst", True, res)
        report["cold_dispatch_s"] = dispatch_seconds(err)
        runs["gpu_matrix"], _ = gpu_run("gpu_matrix", False, res)
        runs["gpu_subst_devpred"], _ = gpu_run("gpu_subst_devpred", True, res + dev)
        runs["gpu_matrix_devpred"], _ = gpu_run("gpu_matrix_devpred", False, res + dev)
    else:
        runs["gpu4_subst_slab"], _ = gpu_run(
            "gpu4_subst_slab", True, base + ["--resident-db", "off"])
        runs["gpu4_subst"], _ = gpu_run("gpu4_subst", True, res)
        runs["gpu4_matrix"], _ = gpu_run("gpu4_matrix", False, res)
    wait_native(p_s, "native_subst", 900)
    wait_native(p_m, "native_matrix", 900)
    for label, out in runs.items():
        if label.endswith("matrix_devpred"):
            continue
        n = compare_dirs(out, nat_m if "matrix" in label else nat_s)
        log(f"  byte-identical to host native: {label} ({n} files)")
    e2e = {"files": {k: len(os.listdir(v)) for k, v in runs.items()}}
    if "gpu_matrix_devpred" in runs:
        drift_files = printed_drift(runs["gpu_matrix_devpred"], nat_m)
        drift = predict_drift()
        bound = EPS_SCREEN / 2
        log(f"  matrix-mode device predict: largest printed difference "
            f"{drift_files:.4f}; f32-vs-f64 drift {drift:.3e} "
            f"(bound EPS_SCREEN/2 = {bound:.1e})")
        if drift > bound:
            raise AssertionError("device predict drift exceeds its bound")
        e2e.update(printed_drift=drift_files, f32_drift=drift, drift_bound=bound)
    if cards == "0":
        phase_long_predict()
    report["e2e"] = e2e


def phase_long_predict() -> None:
    """Long queries through device prediction (subst mode): byte-identical
    to host prediction on the same alignments."""
    from sift4g_tpu.sift.predict_batch import max_device_query_len

    limit = max_device_query_len()
    if max(LONG_QUERIES.values()) > limit:
        raise AssertionError(f"long queries exceed the device limit {limit} aa")
    make_long_queries()
    res = ["--cards", "0", "--resident-db", "on"]
    host, _ = gpu_run("long_host", True, res, qdir=LONG)
    dev, _ = gpu_run("long_devpred", True, res + ["--predict-backend", "device"],
                     qdir=LONG)
    n = compare_dirs(dev, host)
    log(f"  byte-identical: device vs host predict, {n} long queries "
        f"({', '.join(f'{k} {v} aa' for k, v in LONG_QUERIES.items())})")


# ---------------------------------------------------------------- workers

def worker(mode: str) -> int:
    from sift4g_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"error: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 3
    log(f"phase 1: {card_line()}; jax {jax.__version__}; "
        f"{len(devs)} x {dev.device_kind}")
    report = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(devs)}}
    if mode == "four":
        if len(devs) < 4:
            print(f"error: --four-cards needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 3
        log("phase 3 (4 cards): --cards 0123, slab and resident")
        phase_e2e(report, "0123")
    else:
        log("phase 2: kernel parity at real widths")
        phase_kernel(report)
        log("phase 3: end to end through the CLI")
        phase_e2e(report, "0")
    with open(REPORT, "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


def phase_serve(report: dict) -> None:
    """Phase 4: a --serve daemon owns the card; two --connect jobs."""
    sock = os.path.join(WORK, "daemon.sock")
    if os.path.exists(sock):
        os.unlink(sock)
    logf = open(os.path.join(OUT, "daemon.log"), "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "sift4g_tpu", "--serve", sock],
        cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(sock):
            if daemon.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("daemon did not start")
            time.sleep(0.2)
        for label, subst in (("served_subst", True), ("served_matrix", False)):
            out = os.path.join(OUT, label)
            os.makedirs(out, exist_ok=True)
            t0 = time.perf_counter()
            entries = cache_entries()
            argv = [sys.executable, "-m", "sift4g_tpu", "--connect", sock] + cli_argv(
                out, subst=subst, backend="auto",
                extra=["--cards", "0", "--resident-db", "on"])
            r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-4000:])
                raise RuntimeError(f"served job {label} exited {r.returncode}")
            ref = os.path.join(OUT, "gpu_subst" if subst else "gpu_matrix")
            n = compare_dirs(out, ref)
            disp = dispatch_seconds(r.stderr)
            log(f"  {label}: {time.perf_counter() - t0:.1f} s, align.dispatch "
                f"{disp:.3f} s, equal to phase 3 ({n} files)")
            if subst:
                new = cache_entries() - entries
                log(f"  compile cache: {entries} entries, {new} added by the "
                    f"daemon's first job; its align.dispatch {disp:.3f} s vs "
                    f"{report['cold_dispatch_s']:.3f} s cold")
                if new:
                    raise AssertionError(
                        f"the daemon's first job compiled {new} executables "
                        "that phase 3 had stored in the compile cache")
        subprocess.run([sys.executable, "-m", "sift4g_tpu", "--connect", sock,
                        "--shutdown"], cwd=ROOT, timeout=60)
        daemon.wait(timeout=60)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--worker", choices=["one", "four"], help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "sift4g_tpu")):
        print("error: chip_smoke.py must run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.worker:
        return worker(args.worker)

    os.makedirs(OUT, exist_ok=True)
    if os.path.exists(REPORT):
        os.unlink(REPORT)
    t0 = time.perf_counter()
    mode = "four" if args.four_cards else "one"
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--worker", mode], cwd=ROOT).returncode
    if rc != 0 or not os.path.exists(REPORT):
        print(f"error: chip smoke failed (worker exit {rc})", file=sys.stderr)
        return 1
    with open(REPORT) as fh:
        report = json.load(fh)
    if not args.four_cards:
        log("phase 4: served path")
        try:
            phase_serve(report)
        except Exception as exc:
            print(f"error: served path failed: {exc}", file=sys.stderr)
            return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": report["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

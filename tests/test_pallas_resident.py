"""Device-resident grouped kernel: exact equality with the slab kernel.

The resident variant reads each target at its element offset in a flat
database codes array (pallas_sw.py ``sw_scores_pallas_grouped_resident``)
instead of from a host-shipped (G, B, N) slab.  Its correctness contract
is bit-equality with ``sw_scores_pallas_grouped`` fed the same targets,
reading only the bytes inside each target's length.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sift4g_tpu.align.pallas_sw import (
    PAD_CODE,
    sw_scores_pallas_grouped,
    sw_scores_pallas_grouped_resident,
)
from sift4g_tpu.align.xla import _extend_matrix
from sift4g_tpu.core.scorers import create_scorer


@pytest.mark.parametrize("layout", ["packed", "gapped"])
@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_resident_equals_slab_kernel(mode, layout):
    """``packed``: targets back to back, as ResidentDB stores them;
    ``gapped``: arbitrary offsets with garbage between targets."""
    rng = np.random.default_rng(11)
    G, B, N, mq = 2, 8, 128, 64
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = jnp.asarray(_extend_matrix(scorer.matrix))

    lens = rng.integers(1, N + 1, (G, B)).astype(np.int32)
    lens[0, 0] = 0  # empty-target row
    if layout == "packed":
        starts = np.concatenate(([0], np.cumsum(lens.reshape(-1))[:-1]))
        starts = starts.astype(np.int32).reshape(G, B)
        db = rng.integers(0, 26, int(lens.sum())).astype(np.uint8)
    else:
        R = 5000
        db = rng.integers(0, 256, R).astype(np.uint8)  # garbage everywhere
        starts = rng.integers(0, R - N, (G, B)).astype(np.int32)
        for g in range(G):
            for b in range(B):
                s0 = starts[g, b]
                db[s0 : s0 + lens[g, b]] = rng.integers(0, 26, lens[g, b])

    # slab twin: the same targets, PAD past each length
    tg = np.full((G, B, N), PAD_CODE, np.int8)
    for g in range(G):
        for b in range(B):
            tg[g, b, : lens[g, b]] = db[starts[g, b] : starts[g, b] + lens[g, b]]

    q = np.full(G * mq, PAD_CODE, np.int32)
    qo = (np.arange(G) * mq).astype(np.int32)
    ql = rng.integers(5, mq - 2, G).astype(np.int32)
    for g in range(G):
        q[g * mq : g * mq + ql[g]] = rng.integers(0, 26, ql[g])

    kw = dict(mode=mode, gap_open=10, gap_extend=1)
    want = np.asarray(
        sw_scores_pallas_grouped(
            jnp.asarray(q), jnp.asarray(qo), jnp.asarray(ql),
            jnp.asarray(tg), jnp.asarray(lens), m32, **kw
        )
    )
    got = np.asarray(
        sw_scores_pallas_grouped_resident(
            jnp.asarray(q), jnp.asarray(qo), jnp.asarray(ql),
            jnp.asarray(db), jnp.asarray(starts), jnp.asarray(lens),
            m32, N, **kw
        )
    )
    np.testing.assert_array_equal(got[lens > 0], want[lens > 0])


def test_resident_reads_only_inside_lengths():
    """Targets ending at the very last byte of the device array, with a
    length rung far past it: the kernel reads nothing beyond a target's
    length, so the array needs no tail padding."""
    from sift4g_tpu.align.dp_numpy import score_pair

    rng = np.random.default_rng(17)
    B, N, mq = 8, 1536, 64
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = jnp.asarray(_extend_matrix(scorer.matrix))
    lens_seq = rng.integers(20, 120, B).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)

    qlen = 32
    q = np.full(mq, PAD_CODE, np.int32)
    qcodes = rng.integers(0, 26, qlen).astype(np.uint8)
    q[:qlen] = qcodes
    got = np.asarray(
        sw_scores_pallas_grouped_resident(
            jnp.asarray(q), jnp.zeros(1, jnp.int32),
            jnp.asarray(np.array([qlen], np.int32)),
            jnp.asarray(db), jnp.asarray(offsets[:-1].astype(np.int32)[None]),
            jnp.asarray(lens_seq.astype(np.int32)[None]), m32, N,
            mode="SW", gap_open=10, gap_extend=1,
        )
    )[0]
    for b in range(B):
        t = db[offsets[b] : offsets[b + 1]]
        assert got[b] == score_pair(qcodes, t, scorer, "SW"), b


def test_resident_matches_oracle_scores():
    """End-to-end exactness: resident scores == NumPy DP oracle on real
    (start, len) rows of a ResidentDB (not just slab parity)."""
    from sift4g_tpu.align.batch import ResidentDB
    from sift4g_tpu.align.dp_numpy import score_pair

    rng = np.random.default_rng(12)
    B, N, mq = 8, 128, 64
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = jnp.asarray(_extend_matrix(scorer.matrix))

    lens_seq = rng.integers(10, N, 32).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(db, offsets)

    sel = rng.choice(32, B, replace=False)
    starts = rdb.offsets[sel].astype(np.int32).reshape(1, B)
    lens = lens_seq[sel].astype(np.int32).reshape(1, B)

    qlen = 40
    q = np.full(mq, PAD_CODE, np.int32)
    qcodes = rng.integers(0, 26, qlen).astype(np.uint8)
    q[:qlen] = qcodes
    got = np.asarray(
        sw_scores_pallas_grouped_resident(
            jnp.asarray(q), jnp.zeros(1, jnp.int32),
            jnp.asarray(np.array([qlen], np.int32)),
            rdb.dev[0], jnp.asarray(starts), jnp.asarray(lens),
            m32, N, mode="SW", gap_open=10, gap_extend=1,
        )
    )[0]
    for b in range(B):
        t = db[starts[0, b] : starts[0, b] + lens[0, b]]
        want = score_pair(qcodes, t, scorer, "SW")
        assert got[b] == want, (b, got[b], want)


def test_batch_aligner_resident_path():
    """BatchAligner with a ResidentDB ships offsets (the resident kernel)
    and scores bit-equal to the numpy oracle backend."""
    from sift4g_tpu.align.batch import BatchAligner, ResidentDB

    rng = np.random.default_rng(21)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    lens_seq = rng.integers(10, 120, 64).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(db, offsets)

    q = rng.integers(0, 26, 40).astype(np.uint8)
    ids = np.arange(64, dtype=np.int64)
    targets = rdb.packed_targets(ids, lens_seq.astype(np.int32))
    items = [(q, targets)]

    want = BatchAligner(scorer, backend="numpy").scores_many(
        [(q, [db[offsets[i] : offsets[i + 1]] for i in range(64)])]
    )[0]

    calls = {"resident": 0}
    import sift4g_tpu.align.batch as batch_mod
    import sift4g_tpu.align.pallas_sw as psw
    orig = psw.sw_scores_pallas_grouped_resident

    def spy(*a, **k):
        calls["resident"] += 1
        return orig(*a, **k)

    psw.sw_scores_pallas_grouped_resident = spy
    saved = dict(batch_mod._GROUPED_SINGLE_CACHE)
    batch_mod._GROUPED_SINGLE_CACHE.clear()  # trace anew through the spy
    try:
        al = BatchAligner(scorer, backend="pallas", b_cap=256, resident=rdb)
        al._mesh = None  # single-device path (tests run an 8-dev CPU mesh)
        got = al.scores_many(items)[0]
    finally:
        psw.sw_scores_pallas_grouped_resident = orig
        batch_mod._GROUPED_SINGLE_CACHE.clear()
        batch_mod._GROUPED_SINGLE_CACHE.update(saved)
    np.testing.assert_array_equal(got, want)
    assert calls["resident"] >= 1, "resident kernel was not used"


def test_segmented_resident_db(monkeypatch):
    """Databases beyond one segment's capacity split into < 2 GiB device
    segments; launches ship segment-LOCAL offsets against the right
    segment array and still score bit-equal to the numpy oracle."""
    from sift4g_tpu.align.batch import BatchAligner, ResidentDB

    monkeypatch.setattr(ResidentDB, "SEG_CAP", 600)       # ~8 seqs/segment
    monkeypatch.setattr(ResidentDB, "DEV_GRAIN", 512)     # 1-2 rungs/seg

    rng = np.random.default_rng(33)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    lens_seq = rng.integers(10, 120, 64).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(db, offsets)
    assert rdb.n_segs > 4, rdb.n_segs
    # layout: every segment array starts at its base and holds whole
    # sequences; arrays are grain multiples (shared jit shapes)
    for s, d in enumerate(rdb.dev):
        lo, hi = int(rdb.seg_base[s]), int(rdb.seg_base[s + 1])
        np.testing.assert_array_equal(np.asarray(d)[: hi - lo], db[lo:hi])
        assert d.shape[0] % ResidentDB.DEV_GRAIN == 0
    assert len({int(d.shape[0]) for d in rdb.dev}) <= 2

    q = rng.integers(0, 26, 40).astype(np.uint8)
    ids = np.arange(64, dtype=np.int64)
    targets = rdb.packed_targets(ids, lens_seq.astype(np.int32))

    want = BatchAligner(scorer, backend="numpy").scores_many(
        [(q, [db[offsets[i] : offsets[i + 1]] for i in range(64)])]
    )[0]

    seen_segs = set()
    import sift4g_tpu.align.batch as batch_mod
    orig = batch_mod._grouped_single_fn

    def spy_factory(impl, resident_npad, *a, **k):
        fn = orig(impl, resident_npad, *a, **k)
        if not resident_npad:
            return fn

        def launch(qc, qo, ql, db_flat, ts, tls, *rest):
            # segment purity: every offset of a launch addresses bytes
            # inside the segment array it was given
            ts_np, tl_np = np.asarray(ts), np.asarray(tls)
            assert int((ts_np + tl_np).max()) <= db_flat.shape[0]
            assert int(ts_np.min()) >= 0
            seen_segs.add(id(db_flat))
            return fn(qc, qo, ql, db_flat, ts, tls, *rest)

        return launch

    monkeypatch.setattr(batch_mod, "_grouped_single_fn", spy_factory)
    al = BatchAligner(scorer, backend="pallas", b_cap=256, resident=rdb)
    al._mesh = None
    got = al.scores_many([(q, targets)])[0]
    np.testing.assert_array_equal(got, want)
    assert len(seen_segs) == rdb.n_segs  # every segment got its own launch


def _single_device(monkeypatch):
    """BatchAligner without a mesh (the conftest provides 8 devices)."""
    import sift4g_tpu.align.batch as batch_mod

    orig_init = batch_mod.BatchAligner.__init__

    def no_mesh_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self._mesh = None

    monkeypatch.setattr(batch_mod.BatchAligner, "__init__", no_mesh_init)


def test_auto_gate_reuses_live_upload(tmp_path, monkeypatch):
    """_maybe_resident_db("auto"): a candidate volume below the database
    size normally keeps the slab path, but a LIVE ResidentDB for the same
    database is sunk cost (serve daemon, warm repeats) and is reused."""
    import sift4g_tpu.align.batch as batch_mod
    import sift4g_tpu.pipeline as P
    from sift4g_tpu.align.batch import BatchAligner
    from sift4g_tpu.core.scorers import create_scorer as mk
    from sift4g_tpu.io.fasta import FastaStream

    rng = np.random.default_rng(9)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(50):
            fh.write(b">t%d\n%s\n" % (i, rng.choice(aas, 100).tobytes()))

    # non-cpu platform so the auto gate does not bail on platform (the
    # gate does a local `import jax; jax.devices()`)
    class _Dev:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 16 * 2**30}

    import jax as _jax
    monkeypatch.setattr(_jax, "devices", lambda *a: [_Dev()])

    al = BatchAligner(mk("BLOSUM_62", 10, 1), backend="pallas")
    al._mesh = None
    import os
    with FastaStream(str(tmp_path / "db.fa")) as fs:
        # tiny candidate volume: gate must refuse while nothing is cached
        batch_mod._RESIDENT_CACHE.clear()
        got = P._maybe_resident_db(fs, [[0]], al, "auto", open(os.devnull, "w"))
        assert got is None
        # prime the cache (an "earlier job" uploaded this database)
        rdb = batch_mod.get_resident_db(fs._codes, fs._offsets)
        got = P._maybe_resident_db(fs, [[0]], al, "auto", open(os.devnull, "w"))
        assert got is rdb
        batch_mod._RESIDENT_CACHE.clear()


def test_resident_shard_record_range(tmp_path, monkeypatch):
    """Under a multi-host record_range shard, only the shard slice is
    uploaded (shard-local resident layout); alignment records equal the
    slab path's on the same shard."""
    import os

    import sift4g_tpu.align.batch as batch_mod
    from sift4g_tpu.core.evalue import create_evalue_params
    from sift4g_tpu.core.scorers import create_scorer as mk
    from sift4g_tpu.io.fasta import FastaStream, read_fasta
    from sift4g_tpu.pipeline import align_database

    _single_device(monkeypatch)
    rng = np.random.default_rng(4)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    qs = [rng.choice(aas, 90).tobytes() for _ in range(2)]
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(120):
            fh.write(b">t%d\n%s\n" % (i, rng.choice(aas, int(rng.integers(40, 200))).tobytes()))
        for i, s in enumerate(qs):
            fh.write(b">h%d\n%s\n" % (i, s))
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))

    queries = read_fasta(str(tmp_path / "q.fa"))
    scorer = mk("BLOSUM_62", 10, 1)
    ep = create_evalue_params(40_000, scorer)
    lo, hi = 60, 122  # shard containing the homologs
    # candidates: all shard records, global ids
    indices = [np.arange(lo, hi, dtype=np.int64) for _ in queries]

    uploads = {}
    orig_init = batch_mod.ResidentDB.__init__

    def spy_init(self, codes, offsets, *a, **k):
        uploads["n_records"] = offsets.shape[0] - 1
        orig_init(self, codes, offsets, *a, **k)

    monkeypatch.setattr(batch_mod.ResidentDB, "__init__", spy_init)

    recs = {}
    for mode in ("off", "on"):
        batch_mod._RESIDENT_CACHE.clear()
        recs[mode] = align_database(
            str(tmp_path / "db.fa"), queries,
            [ix.copy() for ix in indices], scorer, ep, 1e4, 400,
            backend="pallas", record_range=(lo, hi),
            resident_db=mode, log=open(os.devnull, "w"),
        )
    batch_mod._RESIDENT_CACHE.clear()
    assert uploads["n_records"] == hi - lo  # shard slice only
    for a, b in zip(recs["on"], recs["off"]):
        assert [(r.target_idx, r.score, r.target_name) for r in a] == \
               [(r.target_idx, r.score, r.target_name) for r in b]
        assert len(a) > 0


def test_pipeline_resident_outputs_match_slab(tmp_path, monkeypatch):
    """run_pipeline with resident_db on vs off writes byte-identical
    .SIFTprediction files (the whole align->select->predict chain consumes
    resident-backed PackedTargets).  Homolog copies of the queries are
    planted so alignments survive the E-value filter."""
    import filecmp
    import os

    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

    _single_device(monkeypatch)

    rng = np.random.default_rng(5)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    qs = [rng.choice(aas, 120).tobytes() for _ in range(3)]
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(300):
            seq = rng.choice(aas, int(rng.integers(40, 300))).tobytes()
            fh.write(b">t%d\n%s\n" % (i, seq))
        for i, s in enumerate(qs):  # exact homologs pass the E-value filter
            fh.write(b">h%d\n%s\n" % (i, s))
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))

    outs = {}
    for mode in ("off", "on"):
        out = tmp_path / f"out_{mode}"
        os.makedirs(out)
        cfg = PipelineConfig(
            query_path=str(tmp_path / "q.fa"),
            database_path=str(tmp_path / "db.fa"),
            out_path=str(out),
            align_backend="pallas",
            resident_db=mode,
            log=open(os.devnull, "w"),
        )
        run_pipeline(cfg)
        outs[mode] = sorted(
            f for f in os.listdir(out) if f.endswith(".SIFTprediction")
        )
    assert outs["on"] == outs["off"] and len(outs["on"]) == 3
    for name in outs["on"]:
        assert filecmp.cmp(
            tmp_path / "out_on" / name, tmp_path / "out_off" / name,
            shallow=False,
        ), name


def test_mesh_resident_byte_equals_single_device_slab(monkeypatch):
    """Mesh + resident byte-equals the single-device slab path on a
    mixed-length batch (the XLA scan for CPU speed).  Also locks
    the launch accounting: resident launches scale with (rung, G_CHUNK),
    and the G axis stays shardable (G_CHUNK rounds to n_dev)."""
    import jax

    import sift4g_tpu.align.batch as batch_mod
    from sift4g_tpu.align.batch import BatchAligner, ResidentDB

    rng = np.random.default_rng(29)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    lens_seq = rng.integers(10, 300, 96).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    db = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)

    raw = [db[offsets[i] : offsets[i + 1]] for i in range(96)]
    queries = [rng.integers(0, 26, int(l)).astype(np.uint8) for l in (40, 75)]

    # single-device slab reference (xla grouped twin, no resident)
    slab = BatchAligner(scorer, backend="xla", b_cap=32)
    slab._mesh = None
    want = slab.scores_many([(q, raw) for q in queries])

    # mesh + resident: replicated segments, group-axis-sharded offsets
    from sift4g_tpu.parallel.sharded import make_mesh

    mesh = make_mesh()
    rdb = ResidentDB(db, offsets, mesh=mesh)
    ids = np.arange(96, dtype=np.int64)
    al = BatchAligner(scorer, backend="xla", b_cap=32, resident=rdb)
    assert al._mesh is not None, "conftest provides 8 virtual devices"

    res_calls = {"n": 0}
    import sift4g_tpu.parallel.sharded as sh
    orig = sh.make_grouped_resident_sharded

    def spy(*a, **k):
        res_calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sh, "make_grouped_resident_sharded", spy)
    items = [
        (q, rdb.packed_targets(ids, lens_seq.astype(np.int32)))
        for q in queries
    ]
    got = al.scores_many(items)
    assert res_calls["n"] >= 1, "mesh resident path was not used"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # launches scale with rung buckets, and each grid is n_dev-divisible
    n_dev = al._mesh.devices.size
    assert al.launches <= 4, al.launches


def test_pipeline_mesh_resident_enabled_and_matches(tmp_path, monkeypatch):
    """With a mesh present, _maybe_resident_db ENABLES the resident path,
    the pipeline runs resident launches under shard_map, and outputs
    byte-equal resident-off.  The grouped/resident steps use the exact
    XLA scan (CPU speed)."""
    import filecmp
    import os

    import sift4g_tpu.align.batch as batch_mod
    import sift4g_tpu.pipeline as P
    from sift4g_tpu.pipeline import PipelineConfig, run_pipeline

    # pallas backend picks up the conftest 8-device mesh; substitute the
    # exact XLA scan for the kernel (CPU speed)
    orig_init = batch_mod.BatchAligner.__init__

    def xla_impl_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.grouped_impl = "xla"

    monkeypatch.setattr(batch_mod.BatchAligner, "__init__", xla_impl_init)

    rng = np.random.default_rng(7)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    qs = [rng.choice(aas, 110).tobytes() for _ in range(2)]
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(200):
            seq = rng.choice(aas, int(rng.integers(40, 250))).tobytes()
            fh.write(b">t%d\n%s\n" % (i, seq))
        for i, s in enumerate(qs):  # homologs survive the E-value filter
            fh.write(b">h%d\n%s\n" % (i, s))
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))

    seen = {"mesh": None, "resident": 0}
    orig_maybe = P._maybe_resident_db

    def spy_maybe(fs, indices, aligner, mode_flag, log, record_range=None):
        got = orig_maybe(fs, indices, aligner, mode_flag, log, record_range)
        if mode_flag == "on":
            seen["mesh"] = aligner._mesh
            seen["resident"] = got
        return got

    monkeypatch.setattr(P, "_maybe_resident_db", spy_maybe)

    outs = {}
    for mode in ("off", "on"):
        batch_mod._RESIDENT_CACHE.clear()
        out = tmp_path / f"mesh_{mode}"
        os.makedirs(out)
        cfg = PipelineConfig(
            query_path=str(tmp_path / "q.fa"),
            database_path=str(tmp_path / "db.fa"),
            out_path=str(out),
            align_backend="pallas",
            resident_db=mode,
            log=open(os.devnull, "w"),
        )
        run_pipeline(cfg)
        outs[mode] = sorted(
            f for f in os.listdir(out) if f.endswith(".SIFTprediction")
        )
    batch_mod._RESIDENT_CACHE.clear()
    assert seen["mesh"] is not None, "aligner had no mesh"
    assert seen["resident"] is not None, "resident refused under the mesh"
    assert outs["on"] == outs["off"] and len(outs["on"]) == 2
    for name in outs["on"]:
        assert filecmp.cmp(
            tmp_path / "mesh_on" / name, tmp_path / "mesh_off" / name,
            shallow=False,
        ), name

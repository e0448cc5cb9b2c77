"""Multi-device grouped scoring path on the CPU mesh.

* the GPU kernel's composition with shard_map (group axis, slab and
  resident) is checked directly on small launches in interpret mode;
* the PACKING + SHARDING + MERGE logic of the production multi-device
  path (BatchAligner with a mesh) is checked with the exact XLA scan
  (``grouped_impl="xla"``) on realistic mixed-length batches, for speed.

On a GPU host the production path runs the kernel; kernel and scan are
exact-integer and tested equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.batch import BatchAligner
from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
from sift4g_tpu.align.xla import PAD_CODE, _extend_matrix
from sift4g_tpu.core.scorers import create_scorer
from sift4g_tpu.parallel.sharded import (
    make_grouped_resident_sharded,
    make_grouped_sharded,
    make_mesh,
)


def _grouped_batch(rng, G, B, N, qlen, lo=5):
    tg = np.full((G, B, N), PAD_CODE, dtype=np.int8)
    tl = np.zeros((G, B), dtype=np.int32)
    for g in range(G):
        for b in range(B):
            ln = int(rng.integers(lo, N))
            tg[g, b, :ln] = rng.integers(0, 26, ln)
            tl[g, b] = ln
    q = np.full(64, PAD_CODE, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    return q, np.zeros(G, np.int32), np.full(G, qlen, np.int32), tg, tl


def test_sharded_pallas_scores_match():
    """The resident kernel under shard_map: replicated database array,
    group-axis-sharded offsets, equal to the single-device launch."""
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped_resident

    rng = np.random.default_rng(3)
    G, B, qlen = 8, 8, 41
    lens = rng.integers(1, 128, size=(G, B)).astype(np.int32)
    db = rng.integers(0, 26, int(lens.sum())).astype(np.uint8)
    starts = np.concatenate(([0], np.cumsum(lens.reshape(-1))[:-1]))
    starts = starts.astype(np.int32).reshape(G, B)
    q = np.full(64, PAD_CODE, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, size=qlen)
    go, gl = np.zeros(G, np.int32), np.full(G, qlen, np.int32)
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix)

    ref = np.asarray(sw_scores_pallas_grouped_resident(
        q, go, gl, db, starts, lens, m32, 128))
    fn = make_grouped_resident_sharded(make_mesh(8), n_pad=128)
    got = np.asarray(fn(q, go, gl, db, starts, lens, m32))
    np.testing.assert_array_equal(got, ref)


def test_sharded_grouped_pallas_kernel_matches():
    """The production grouped kernel composes with shard_map over the
    GROUP axis (one small launch shape; interpret mode)."""
    rng = np.random.default_rng(0)
    q, go, gl, tg, tl = _grouped_batch(rng, 8, 16, 128, 48)
    m32 = np.asarray(_extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix))
    ref = np.asarray(sw_scores_pallas_grouped(q, go, gl, tg, tl, m32))
    fn = make_grouped_sharded(make_mesh(8))
    got = np.asarray(fn(q, go, gl, tg, tl, m32))
    np.testing.assert_array_equal(got, ref)


def test_sharded_grouped_long_kernel_matches():
    """Long targets under the mesh: the same kernel with a long column
    loop, group-axis sharded, equal to the NumPy oracle."""
    from sift4g_tpu.align.dp_numpy import score_pair

    rng = np.random.default_rng(1)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q, go, gl, tg, tl = _grouped_batch(rng, 8, 4, 768, 12, lo=500)
    fn = make_grouped_sharded(make_mesh(8))
    got = np.asarray(fn(q, go, gl, tg, tl, _extend_matrix(scorer.matrix)))
    want = [
        [score_pair(q[:12].astype(np.uint8), tg[g, b, : tl[g, b]].astype(np.uint8),
                    scorer, "SW") for b in range(4)]
        for g in range(8)
    ]
    np.testing.assert_array_equal(got, want)


def _mixed_items(rng, n_queries=5, max_tlen=700):
    """Realistic mixed-length batch: queries of varying length, targets
    spanning several padded-length rungs."""
    items = []
    for _ in range(n_queries):
        q = rng.integers(0, 26, int(rng.integers(30, 120))).astype(np.uint8)
        targets = [
            rng.integers(0, 26, int(rng.integers(5, max_tlen))).astype(np.uint8)
            for _ in range(int(rng.integers(10, 40)))
        ]
        items.append((q, targets))
    return items


def _aligner(scorer, mesh=True, backend="pallas", **kw):
    kw.setdefault("b_cap", 32)
    al = BatchAligner(scorer, backend=backend, **kw)
    al.grouped_impl = "xla"
    if not mesh:
        al._mesh = None
    return al


def test_sharded_grouped_byte_equals_single_device():
    """With a mesh, BatchAligner packs the SAME grouped launches as
    single-device (rung ladder, adaptive width, native fill),
    shards the group axis, and the scores byte-equal the single-device
    grouped path AND the NumPy oracle on a realistic mixed-length batch."""
    rng = np.random.default_rng(11)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    items = _mixed_items(rng)
    ref = BatchAligner(scorer, backend="numpy").scores_many(items)
    got_single = _aligner(scorer, mesh=False).scores_many(items)
    sharded = _aligner(scorer)
    assert sharded._mesh is not None, "conftest provides 8 virtual devices"
    got_sharded = sharded.scores_many(items)
    for r, s, m in zip(ref, got_single, got_sharded):
        np.testing.assert_array_equal(s, r)
        np.testing.assert_array_equal(m, r)


def test_sharded_long_targets_fall_back_safely():
    """With a mesh, long-target buckets ride the same grouped launches
    (target length is a loop bound, not a buffer budget) and stay
    exact."""
    rng = np.random.default_rng(13)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 70).astype(np.uint8)
    targets = [
        rng.integers(0, 26, 2500).astype(np.uint8),   # a long rung
        rng.integers(0, 26, 2210).astype(np.uint8),
        rng.integers(0, 26, 140).astype(np.uint8),    # short: grouped kernel
    ]
    ref = BatchAligner(scorer, backend="numpy").scores_many([(q, targets)])[0]
    al = _aligner(scorer)
    got = al.scores_many([(q, targets)])[0]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sharded_launches_scale_with_buckets_not_queries(backend, monkeypatch):
    """Kernel launches scale with (rung bucket, G_CHUNK) chunks, never
    with queries x buckets — for BOTH backends, which share one grouped
    launch-policy path.

    Both tail-coalescing policies are asserted: with coalescing OFF each
    rung launches once (2 rungs -> 2 launches); with it ON (production
    default) every query's 128-rung remainder merges into its 512-rung
    tail group (fewer padded cells), collapsing the whole batch to ONE
    launch — byte-equal scores either way."""
    rng = np.random.default_rng(7)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    items = []
    for _ in range(6):   # 6 queries x 2 rungs (128/512) = 12 groups
        q = rng.integers(0, 26, 50).astype(np.uint8)
        targets = [rng.integers(0, 26, 100).astype(np.uint8) for _ in range(3)]
        targets += [rng.integers(0, 26, 500).astype(np.uint8) for _ in range(3)]
        items.append((q, targets))
    ref = BatchAligner(scorer, backend="numpy").scores_many(items)

    monkeypatch.setenv("SIFT4G_TPU_TAIL_COALESCE", "0")
    al = _aligner(scorer, backend=backend)
    assert al._mesh is not None
    got = al.scores_many(items)
    assert al.launches == 2, (
        f"expected one launch per (rung, G_CHUNK) bucket chunk, got {al.launches}"
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)

    monkeypatch.delenv("SIFT4G_TPU_TAIL_COALESCE")
    al = _aligner(scorer, backend=backend)
    got = al.scores_many(items)
    assert al.launches == 1, (
        f"expected coalesced tails to collapse to one launch, got {al.launches}"
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)

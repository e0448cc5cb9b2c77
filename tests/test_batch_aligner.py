"""BatchAligner backends agree (numpy vs xla vs the grouped GPU kernel in
interpret mode)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.batch import BatchAligner
from sift4g_tpu.core.scorers import create_scorer


def _items(rng, n_queries=3, per_query=(0, 5, 23)):
    items = []
    for qi in range(n_queries):
        q = rng.integers(0, 26, int(rng.integers(20, 90))).astype(np.uint8)
        n_t = per_query[qi % len(per_query)]
        targets = [
            rng.integers(0, 26, int(rng.integers(3, 300))).astype(np.uint8)
            for _ in range(n_t)
        ]
        items.append((q, targets))
    return items


def test_long_targets_route_through_chunked_kernel():
    """Long targets ride the same grouped kernel (their rung's longer
    column loop) next to short ones, exact against the oracle."""
    rng = np.random.default_rng(5)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 70).astype(np.uint8)
    targets = [
        rng.integers(0, 26, 2500).astype(np.uint8),   # long rung
        rng.integers(0, 26, 3100).astype(np.uint8),   # long rung
        rng.integers(0, 26, 140).astype(np.uint8),    # short rung
    ]
    ref = BatchAligner(scorer, backend="numpy").scores_many([(q, targets)])[0]
    al = BatchAligner(scorer, backend="pallas", b_cap=8)
    al._mesh = None
    got = al.scores_many([(q, targets)])[0]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["SW", "NW"])
def test_backends_agree_scores_many(mode):
    rng = np.random.default_rng(77)
    items = _items(rng)
    scorer = create_scorer("BLOSUM_62", 10, 1)

    ref = BatchAligner(scorer, mode=mode, backend="numpy").scores_many(items)
    got_xla = BatchAligner(scorer, mode=mode, backend="xla", b_cap=8).scores_many(items)
    al = BatchAligner(scorer, mode=mode, backend="pallas", b_cap=8)
    al._mesh = None  # single-device path
    got_pl = al.scores_many(items)
    for r, x, p in zip(ref, got_xla, got_pl):
        np.testing.assert_array_equal(x, r)
        np.testing.assert_array_equal(p, r)


def test_length_rungs_vec_matches_scalar():
    from sift4g_tpu.align.batch import _length_rung, _length_rungs_vec

    lens = np.concatenate([
        np.arange(1, 2000), np.array([2048, 2049, 3072, 3073, 10000, 35000])
    ])
    vec = _length_rungs_vec(lens, 128)
    for n, v in zip(lens.tolist(), vec.tolist()):
        assert v == _length_rung(n, 128), n


def test_tail_policy_pow2_scores_identical():
    """tail_policy="pow2" shrinks remainder groups to 256*2^k lanes; the
    retained scores must be bit-identical to the full-width policy (padding
    lanes are masked) while the tail group width actually narrows."""
    rng = np.random.default_rng(13)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 64).astype(np.uint8)
    # 700 targets at one rung: full policy packs 512 + 512-wide tail for the
    # 188 remainder; pow2 packs 512 + 256
    targets = [rng.integers(0, 26, int(rng.integers(30, 120))).astype(np.uint8)
               for _ in range(700)]
    items = [(q, targets)]

    ref = BatchAligner(scorer, backend="numpy").scores_many(items)[0]
    got = {}
    for policy in ("full", "pow2"):
        al = BatchAligner(scorer, backend="pallas", b_cap=512, tail_policy=policy)
        al._mesh = None
        al.grouped_impl = "xla"  # exact portable twin; fast on CPU
        got[policy] = al.scores_many(items)[0]
    np.testing.assert_array_equal(got["full"], ref)
    np.testing.assert_array_equal(got["pow2"], ref)

    al = BatchAligner(scorer, backend="pallas", b_cap=512, tail_policy="pow2")
    assert al._group_width(512, 512) == 512
    assert al._group_width(188, 512) == 256
    assert al._group_width(10, 512) == 256
    assert al._group_width(300, 4096) == 512
    al_full = BatchAligner(scorer, backend="pallas", b_cap=512,
                           tail_policy="full")
    assert al_full._group_width(188, 512) == 512
    # pow2 is the production default; shield the assertion from a
    # developer's control env var
    import os
    from unittest import mock

    with mock.patch.dict(os.environ):
        os.environ.pop("SIFT4G_TPU_TAIL_POLICY", None)
        assert BatchAligner(scorer, backend="pallas").tail_policy == "pow2"


def test_tail_coalescing_scores_identical_and_merges():
    """Cross-rung tail coalescing: remainders from smaller rungs merge
    into the largest rung's tail group when the padded-cell cost drops;
    scores stay bit-identical (columns past a target's length are masked
    at any rung), launches drop, and screening (which relies on
    id-ascending rows within a group) keeps the exact survivor set."""
    import os
    from unittest import mock

    rng = np.random.default_rng(29)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    q = rng.integers(0, 26, 64).astype(np.uint8)
    # three rungs' worth of targets, each count below the batch cap ->
    # three per-rung remainders that should coalesce into ONE group
    targets = (
        [rng.integers(0, 26, int(rng.integers(10, 120))).astype(np.uint8)
         for _ in range(40)]        # rung 128
        + [rng.integers(0, 26, int(rng.integers(180, 250))).astype(np.uint8)
           for _ in range(30)]      # rung 256
        + [rng.integers(0, 26, int(rng.integers(300, 380))).astype(np.uint8)
           for _ in range(20)]      # rung 384
    )
    items = [(q, targets)]
    ref = BatchAligner(scorer, backend="numpy").scores_many(items)[0]

    def run(coalesce):
        with mock.patch.dict(os.environ,
                             {"SIFT4G_TPU_TAIL_COALESCE": "1" if coalesce else "0"}):
            al = BatchAligner(scorer, backend="pallas", b_cap=512)
            al._mesh = None
            al.grouped_impl = "xla"
            out = al.scores_many(items)[0]
            return out, al.launches

    got_on, launches_on = run(True)
    got_off, launches_off = run(False)
    np.testing.assert_array_equal(got_on, ref)
    np.testing.assert_array_equal(got_off, ref)
    assert launches_on < launches_off, (launches_on, launches_off)

    # screened path: survivor sets must match the dense filter exactly
    from sift4g_tpu.align.batch import BatchAligner as BA

    smin = int(np.median(ref))
    with mock.patch.dict(os.environ, {"SIFT4G_TPU_TAIL_COALESCE": "1"}):
        al = BA(scorer, backend="pallas", b_cap=512)
        al._mesh = None
        al.grouped_impl = "xla"
        dense = al.scores_many_async(items, screen=([smin], 400))()[0]
    want = np.where(ref >= smin, ref, 0)
    np.testing.assert_array_equal(dense, want)

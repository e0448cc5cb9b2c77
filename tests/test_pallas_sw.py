"""GPU score kernel (interpret mode) == XLA scan, all four modes.

The kernel is the Pallas-Triton one (align/pallas_sw.py); on the CPU it
runs in Pallas interpret mode, on a GPU it compiles (chip_smoke.py checks
it there at real widths).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
from sift4g_tpu.align.xla import PAD_CODE, _extend_matrix, align_scores_kernel
from sift4g_tpu.core.scorers import create_scorer


def _random_batch(rng, b, n, m_pad, qlen):
    targets = np.full((b, n), PAD_CODE, dtype=np.int32)
    lens = rng.integers(1, n + 1, size=b).astype(np.int32)
    for i in range(b):
        targets[i, : lens[i]] = rng.integers(0, 26, size=lens[i])
    q = np.full(m_pad, PAD_CODE, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, size=qlen)
    return q, targets, lens


def _one_group(q, qlen, targets, lens, m32, **kw):
    """The grouped kernel with a single group (G=1)."""
    return np.asarray(
        sw_scores_pallas_grouped(
            q, np.zeros(1, np.int32), np.array([qlen], np.int32),
            targets[None].astype(np.int8), lens[None], m32, **kw
        )
    )[0]


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_pallas_matches_xla(mode):
    rng = np.random.default_rng(11)
    b, n, m_pad, qlen = 16, 128, 64, 57
    q, targets, lens = _random_batch(rng, b, n, m_pad, qlen)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = _extend_matrix(scorer.matrix)

    ref = np.asarray(
        align_scores_kernel(q, np.int32(qlen), targets, lens, m32, mode=mode)
    )
    got = _one_group(q, qlen, targets, lens, m32, mode=mode)
    np.testing.assert_array_equal(got, ref)


def test_pallas_other_matrix_and_gaps():
    """Different scorer + gap params, SW mode."""
    rng = np.random.default_rng(23)
    b, n, m_pad, qlen = 8, 256, 32, 29
    q, targets, lens = _random_batch(rng, b, n, m_pad, qlen)
    scorer = create_scorer("BLOSUM_45", 12, 2)
    m32 = _extend_matrix(scorer.matrix)
    ref = np.asarray(
        align_scores_kernel(
            q, np.int32(qlen), targets, lens, m32, mode="SW", gap_open=12, gap_extend=2
        )
    )
    got = _one_group(q, qlen, targets, lens, m32, mode="SW", gap_open=12,
                     gap_extend=2)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_kernel_lowers_to_valid_triton_ir(mode):
    """The kernel lowers for CUDA (no GPU needed) into Triton IR that
    passes the MLIR verifier — what the GPU compiler checks first."""
    import jax.numpy as jnp
    from jax._src.pallas.triton import lowering as triton_lowering

    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped_resident

    orig = triton_lowering.lower_jaxpr_to_triton_module
    modules = []

    def verified(*a, **k):
        res = orig(*a, **k)
        res.module.operation.verify()  # raises on invalid IR
        modules.append(res)
        return res

    S = jax.ShapeDtypeStruct
    q = (S((128,), jnp.int32), S((2,), jnp.int32), S((2,), jnp.int32))
    tail = (S((2, 256), jnp.int32), S((32, 32), jnp.int32))
    triton_lowering.lower_jaxpr_to_triton_module = verified
    try:
        jax.jit(lambda *a: sw_scores_pallas_grouped(
            *a, mode=mode, interpret=False)).trace(
            *q, S((2, 256, 128), jnp.int8), *tail
        ).lower(lowering_platforms=("cuda",))
        jax.jit(lambda *a: sw_scores_pallas_grouped_resident(
            *a, 512, mode=mode, interpret=False)).trace(
            *q, S((4096,), jnp.uint8), S((2, 256), jnp.int32), *tail
        ).lower(lowering_platforms=("cuda",))
    finally:
        triton_lowering.lower_jaxpr_to_triton_module = orig
    assert len(modules) == 2

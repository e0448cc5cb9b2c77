"""The device path's choices: backend by platform, the plain XLA scan's
memory shape, predict precision, compile cache and mesh errors."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sift4g_tpu.align.dp_numpy import score_pair
from sift4g_tpu.align.xla import PAD_CODE, _extend_matrix, align_scores
from sift4g_tpu.core.scorers import create_scorer


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize(
    "platform,native,want",
    [("gpu", True, "pallas"), ("cpu", True, "native"),
     ("cpu", False, "xla"), ("rocm", True, "xla")],
)
def test_best_backend_by_platform(platform, native, want, monkeypatch):
    import sift4g_tpu.native as native_mod
    from sift4g_tpu.align import best_backend

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    monkeypatch.setattr(native_mod, "load", lambda: object() if native else None)
    assert best_backend() == want


def _all_avals(jaxpr):
    for eqn in jaxpr.eqns:
        for v in eqn.outvars:
            yield v.aval
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _all_avals(sub)


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
def test_xla_scan_builds_no_cell_tensor(mode):
    """The repaired XLA scan looks each row's scores up inside the scan:
    no intermediate holds (m, B, N) cells, and scores stay exact."""
    rng = np.random.default_rng(5)
    m, qlen, B, N = 40, 37, 6, 56
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = _extend_matrix(scorer.matrix)
    q = np.full(m, PAD_CODE, np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    t = rng.integers(-128, 128, (B, N)).astype(np.int32)  # garbage tails
    tl = rng.integers(1, N + 1, B).astype(np.int32)
    for b in range(B):
        t[b, : tl[b]] = rng.integers(0, 26, tl[b])

    def fn(q, t, tl):
        return align_scores(q, jnp.int32(qlen), t, tl, jnp.asarray(m32), mode=mode)

    jaxpr = jax.make_jaxpr(fn)(q, t, tl).jaxpr
    biggest = max(int(np.prod(a.shape)) for a in _all_avals(jaxpr)
                  if hasattr(a, "shape"))
    assert biggest < m * B * N, biggest
    got = np.asarray(jax.jit(fn)(q, t, tl))
    want = [score_pair(q[:qlen].astype(np.uint8), t[b, : tl[b]].astype(np.uint8),
                       scorer, mode) for b in range(B)]
    np.testing.assert_array_equal(got, want)


def test_predict_contractions_pin_highest_precision():
    """Every contraction of the device predict math carries an explicit
    HIGHEST precision (a GPU may otherwise run f32 matmuls in TF32)."""
    from sift4g_tpu.sift.scores_jax import sift_scores_from_rows

    rows = jnp.zeros((8, 16), jnp.int32)
    jaxpr = jax.make_jaxpr(sift_scores_from_rows)(rows, jnp.int32(8)).jaxpr

    def dots(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(jaxpr))
    assert len(found) >= 4
    for eqn in found:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), prec


def test_compile_cache_env_or_checkout_path(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    otherwise one fixed directory inside the checkout.  Either way every
    compile is stored, however short."""
    import sift4g_tpu
    from sift4g_tpu.utils import enable_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert enable_compile_cache() == "/elsewhere/cache"
    assert calls == [("jax_persistent_cache_min_compile_time_secs", 0.0)]
    calls.clear()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(sift4g_tpu.__file__))
    assert path == os.path.join(checkout, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path),
                     ("jax_persistent_cache_min_compile_time_secs", 0.0)]


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from jax._src import monitoring
from sift4g_tpu.utils import enable_compile_cache
hits = []
monitoring.register_event_listener(
    lambda name, **kw: hits.append(name)
    if name == "/jax/compilation_cache/cache_hits" else None)
enable_compile_cache()
jax.jit(lambda x: jnp.cumsum(x * 3 + 1))(jnp.arange(37)).block_until_ready()
print(len(hits))
"""


def test_compile_cache_serves_a_second_process(tmp_path):
    """A short compile written by one process is read back by the next:
    the first run stores entries, the second hits them."""
    import subprocess
    import sys

    import sift4g_tpu

    root = os.path.dirname(os.path.dirname(sift4g_tpu.__file__))
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=root)
    runs = [
        subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       capture_output=True, text=True, timeout=120, check=True)
        for _ in range(2)
    ]
    assert runs[0].stdout.split()[-1] == "0"
    assert os.listdir(tmp_path)
    assert int(runs[1].stdout.split()[-1]) >= 1


def test_mesh_failure_is_an_error(monkeypatch):
    """A mesh that cannot be built raises instead of silently scoring on
    one device."""
    import sift4g_tpu.parallel.sharded as sh
    from sift4g_tpu.align.batch import BatchAligner

    def broken(*a, **k):
        raise RuntimeError("mesh unavailable")

    monkeypatch.setattr(sh, "make_mesh", broken)
    with pytest.raises(RuntimeError, match="mesh unavailable"):
        BatchAligner(create_scorer("BLOSUM_62", 10, 1), backend="xla")


def test_predict_memory_policy_from_device_size(monkeypatch):
    """Launch width and the longest device query follow the device's
    reported memory; a device that reports none refuses the path."""
    from sift4g_tpu import utils
    from sift4g_tpu.sift import predict_batch as pb

    monkeypatch.setattr(pb, "MAX_DEVICE_QUERY_LEN", 0)
    monkeypatch.setattr(utils, "device_memory_bytes", lambda: 64 * 2**30)
    big = pb.max_device_query_len()
    monkeypatch.setattr(utils, "device_memory_bytes", lambda: 16 * 2**30)
    small = pb.max_device_query_len()
    assert big > small >= 4096
    budget = pb._budget_bytes()
    assert pb.chunk_width(512, 448, budget) <= pb.Q_CHUNK_MAX
    assert pb.chunk_width(32768, 448, budget) < pb.chunk_width(512, 448, budget)
    monkeypatch.setattr(utils, "device_memory_bytes", lambda: None)
    with pytest.raises(RuntimeError, match="memory size"):
        pb.max_device_query_len()


@pytest.mark.parametrize("q,l_pad", [(1, 1024), (4, 384)])
def test_predict_peak_estimate_covers_compiled_launch(q, l_pad):
    """XLA's memory analysis of a compiled predict launch stays inside the
    PEAK_PER_ONEHOT estimate the launch widths are derived from."""
    from sift4g_tpu.sift import predict_batch as pb

    ratio = pb.compiled_peak_ratio(q, pb.ROWS_PAD_MAX, l_pad)
    assert 0 < ratio <= pb.PEAK_PER_ONEHOT


@pytest.mark.gpu
def test_kernel_compiles_and_matches_on_gpu():
    """The kernel compiled for the card (no interpret mode) equals the
    XLA scan at a real launch width."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (SIFT4G_TEST_GPU=1 pytest -m gpu "
                    "on the card)")
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
    from sift4g_tpu.align.xla import align_scores_grouped_kernel

    rng = np.random.default_rng(0)
    G, B, N, m = 8, 1024, 512, 360
    q = np.full(G * 384, PAD_CODE, np.int32)
    for g in range(G):
        q[g * 384 : g * 384 + m] = rng.integers(0, 26, m)
    qo = (np.arange(G) * 384).astype(np.int32)
    ql = np.full(G, m, np.int32)
    tg = rng.integers(0, 26, (G, B, N)).astype(np.int8)
    tl = rng.integers(1, N + 1, (G, B)).astype(np.int32)
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix)
    got = np.asarray(sw_scores_pallas_grouped(q, qo, ql, tg, tl, m32))
    want = np.asarray(align_scores_grouped_kernel(q, qo, ql, tg, tl, m32,
                                                  m_window=384))
    np.testing.assert_array_equal(got, want)

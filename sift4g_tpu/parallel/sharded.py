"""Multi-chip scaling: database-sharded scoring with global top-k merge.

The reference's only parallelism is a pthread pool splitting each database
chunk into contiguous ranges with a host-side merge of per-thread top-k
lists (database_search.cpp:101-154) plus optional multi-GPU card lists for
the SW rescoring (database_alignment.cpp:80-86).  The device mapping:

* the grouped launches of the production path shard their GROUP axis over
  a 1-D ``jax.sharding.Mesh`` axis ``"db"`` (make_grouped_sharded /
  make_grouped_resident_sharded): each device runs complete groups with
  the same kernel used single-device;
* the top-k helpers shard the candidate axis instead: per-shard
  ``lax.top_k`` then an ``all_gather`` and a global re-top-k replace the
  host merge — the collective payload is O(k), not O(B);
* global candidate indices are recovered from shard-local ones with
  ``lax.axis_index`` offsets, mirroring the chunk-offset bookkeeping at
  database_search.cpp:208.

Everything is a single jitted SPMD program: XLA lays out the collectives,
no host round trips between scoring and merging.
"""

from __future__ import annotations


from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align.xla import align_scores

DB_AXIS = "db"


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = DB_AXIS,
    cards: Optional[tuple] = None,
) -> Mesh:
    """1-D device mesh over the database axis.

    LOCAL devices only: in a multi-host run each host scores its own
    database shard on its own chips (docs/MULTIHOST.md) — cross-host
    merging is an explicit O(k) exchange, never a global scoring mesh.
    Single-process runs see no difference.

    ``cards`` restricts the mesh to those LOCAL device indices, in the
    given order — the reference's --cards list (main.cpp:254-262 parses
    the digit string; database_alignment.cpp:80-86 fans alignment out over
    exactly those GPUs).  Empty/None = all local devices.  Divergence from
    quirk Q10 documented at the CLI: the reference with NO --cards runs
    CPU-only; here the default is every local accelerator."""
    devices = jax.local_devices()
    if cards:
        bad = [c for c in cards if not (0 <= c < len(devices))]
        if bad:
            raise ValueError(
                f"--cards indices {bad} out of range: {len(devices)} local "
                f"device(s) available"
            )
        devices = [devices[c] for c in cards]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_sharded_topk_align(
    mesh: Mesh,
    *,
    k: int,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    axis: str = DB_AXIS,
):
    """Build a jitted SPMD step: score B sharded targets, return global top-k.

    Returned fn signature::

        fn(query_codes (m_pad,) i32, query_len () i32,
           targets (B, N) i32 sharded on axis 0, target_lens (B,) i32 sharded,
           matrix32 (32, 32) i32 replicated)
          -> (scores (B,) i32 sharded, topk_scores (k,) i32, topk_idx (k,) i32)

    ``B`` must be divisible by the mesh size; the caller pads with dummy
    targets (length 0 scores are the mode's worst case and fall out of the
    top-k).  ``k`` must be <= B // mesh_size so the per-shard top-k is
    well-formed; the global merge re-tops over the gathered n_dev*k pool.
    """
    n_dev = mesh.devices.size

    def local_step(q, ql, t, tl, m32):
        scores = align_scores(
            q, ql, t, tl, m32, mode=mode, gap_open=gap_open, gap_extend=gap_extend
        )
        b_local = t.shape[0]
        kk = min(k, b_local)
        s, i = jax.lax.top_k(scores, kk)
        shard = jax.lax.axis_index(axis)
        gi = i.astype(jnp.int32) + shard.astype(jnp.int32) * b_local
        # O(k) collective; every shard computes the same global merge
        s_all = jax.lax.all_gather(s, axis)    # (n_dev, kk)
        gi_all = jax.lax.all_gather(gi, axis)  # (n_dev, kk)
        pool = s_all.reshape(-1)
        sg, pos = jax.lax.top_k(pool, min(k, pool.shape[0]))
        return scores, sg, gi_all.reshape(-1)[pos]

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis), P()),
        out_specs=(P(axis), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


_GROUPED_CACHE = {}


def make_grouped_sharded(
    mesh: Mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    max_qlen: int = 0,
    axis: str = DB_AXIS,
    kernel: str = "pallas",
    screen_k: int = 0,
):
    """Production multi-device scorer: the grouped GPU kernel under
    shard_map, sharded over the GROUP axis.  ``kernel="xla"`` substitutes
    the exact plain grouped scan (align/xla.py align_scores_grouped).

    Each device runs ``G/n_dev`` complete (query, target-chunk) groups of
    the same grid-of-groups launch used single-device — batch width, rung
    ladder and native fill policy are identical per device.
    The query buffer and matrix are replicated; ``q_offsets`` index into the
    replicated buffer so shards need no offset fixup.  Mirrors the
    reference's multi-GPU ``alignDatabase`` fan-out
    (reference database_alignment.cpp:80-86, cards main.cpp:254-262).

    fn(q_codes_all (Qm,) i32, q_offsets (G,) i32, q_lens (G,) i32,
       targets (G, B, N) i8 sharded on axis 0, target_lens (G, B) i32 sharded,
       matrix32 (32, 32) i32) -> scores (G, B) i32 sharded on axis 0

    ``screen_k`` > 0 fuses device-side exact E-value screening
    (align/xla.py screen_topk_words): the step takes a trailing (G,) i32
    threshold array (sharded like the group axis) and returns (G, screen_k)
    survivor words instead of (G, B) scores.
    """
    key = ("grouped", mesh, mode, gap_open, gap_extend, max_qlen, axis,
           kernel, screen_k)
    if key not in _GROUPED_CACHE:
        from ..align.batch import grouped_local_step

        local_step = grouped_local_step(
            kernel, 0, screen_k, mode=mode, gap_open=gap_open,
            gap_extend=gap_extend, max_qlen=max_qlen,
        )
        extra = (P(axis),) if screen_k else ()
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(axis, None, None),
                      P(axis, None), P()) + extra,
            out_specs=P(axis, None),
            check_vma=False,
        )
        _GROUPED_CACHE[key] = jax.jit(fn)
    return _GROUPED_CACHE[key]


def make_grouped_resident_sharded(
    mesh: Mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    n_pad: int = 512,
    kernel: str = "pallas",
    axis: str = DB_AXIS,
    screen_k: int = 0,
    max_qlen: int = 0,
):
    """Device-resident grouped scorer under shard_map, sharded over the
    GROUP axis.  The resident segment array is REPLICATED across the mesh
    — each device holds the full segment, mirroring the reference's
    per-card resident chains (database_alignment.cpp:80-81: every card
    receives the whole filtered chain database).  Launches ship only the
    (G, B) offset/length arrays, sharded like the slab path's group axis.

    ``kernel="xla"`` substitutes the exact plain twin (align/xla.py
    align_scores_grouped_resident).

    fn(q (Qm,) i32, go (G,) i32 sharded, gl (G,) i32 sharded,
       db_flat (R,) u8 replicated, t_starts (G, B) i32 sharded,
       target_lens (G, B) i32 sharded, matrix32) -> (G, B) i32 sharded
    """
    key = ("grouped_res", mesh, mode, gap_open, gap_extend, n_pad, kernel,
           axis, screen_k, max_qlen)
    if key not in _GROUPED_CACHE:
        from ..align.batch import grouped_local_step

        local_step = grouped_local_step(
            kernel, n_pad, screen_k, mode=mode, gap_open=gap_open,
            gap_extend=gap_extend, max_qlen=max_qlen,
        )
        extra = (P(axis),) if screen_k else ()
        fn = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis), P(), P(axis, None),
                      P(axis, None), P()) + extra,
            out_specs=P(axis, None),
            check_vma=False,
        )
        _GROUPED_CACHE[key] = jax.jit(fn)
    return _GROUPED_CACHE[key]


def replicate_to_mesh(mesh: Mesh, arr):
    """Place a host array on every device of the mesh (fully replicated
    NamedSharding) — the resident segment upload under a mesh."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


def make_2d_mesh(n_devices: Optional[int] = None, q_axis: str = "q", axis: str = DB_AXIS) -> Mesh:
    """2-D mesh: data-parallel query axis x database-shard axis.

    Factors the device count as (2, n/2) when even so both axes are
    exercised; a single device degenerates to (1, 1).  Local devices only
    (see make_mesh).
    """
    devices = jax.local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    nq = 2 if n % 2 == 0 and n > 1 else 1
    return Mesh(np.array(devices).reshape(nq, n // nq), (q_axis, axis))


def make_sharded_pipeline_step(
    mesh: Mesh,
    *,
    k: int,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    q_axis: str = "q",
    axis: str = DB_AXIS,
):
    """Batched-query SPMD step over a 2-D (q, db) mesh.

    Queries are data-parallel over ``q_axis`` (the device analogue of the
    reference's one-task-per-query pthread fan-out,
    select_alignments.cpp:55-65); the candidate axis is sharded over
    ``axis`` with a per-query global top-k merge as in
    :func:`make_sharded_topk_align`.

    fn(queries (Q, m_pad) i32, query_lens (Q,) i32,
       targets (B, N) i32, target_lens (B,) i32, matrix32 (32, 32) i32)
      -> (topk_scores (Q, k) i32, topk_idx (Q, k) i32)
    """

    def local_step(qs, qls, t, tl, m32):
        score_one = lambda q, ql: align_scores(
            q, ql, t, tl, m32, mode=mode, gap_open=gap_open, gap_extend=gap_extend
        )
        scores = jax.vmap(score_one)(qs, qls)          # (Q_loc, B_loc)
        b_local = t.shape[0]
        kk = min(k, b_local)
        s, i = jax.lax.top_k(scores, kk)               # (Q_loc, kk)
        shard = jax.lax.axis_index(axis)
        gi = i.astype(jnp.int32) + shard.astype(jnp.int32) * b_local
        s_all = jax.lax.all_gather(s, axis, axis=1)    # (Q_loc, n_db, kk)
        gi_all = jax.lax.all_gather(gi, axis, axis=1)
        pool = s_all.reshape(s.shape[0], -1)
        sg, pos = jax.lax.top_k(pool, min(k, pool.shape[1]))
        return sg, jnp.take_along_axis(gi_all.reshape(s.shape[0], -1), pos, axis=1)

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(q_axis, None), P(q_axis), P(axis, None), P(axis), P()),
        out_specs=(P(q_axis, None), P(q_axis, None)),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_batch(mesh: Mesh, targets: np.ndarray, target_lens: np.ndarray, axis: str = DB_AXIS):
    """Place a padded (B, N) target batch sharded over the mesh's db axis."""
    t_sharding = NamedSharding(mesh, P(axis, None))
    l_sharding = NamedSharding(mesh, P(axis))
    return (
        jax.device_put(targets, t_sharding),
        jax.device_put(target_lens, l_sharding),
    )

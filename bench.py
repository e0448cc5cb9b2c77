"""Time the grouped GPU score kernel against the plain XLA version.

    python bench.py [--groups 64] [--batch 1024] [--n 512] [--m 360]
                    [--iters 5] [--sweep]

Both run the same grouped launch — G queries of length m, each against B
random targets of length n, BLOSUM62 10/1, SW — with unique device inputs
per call and a forced host fetch, so each time covers dispatch, the
kernel and the result transfer.  The first call of each is its compile
(reported separately).  The kernel's scores must equal the XLA scan's
exactly.  ``--sweep`` also times the kernel's tuning variants (rows per
strip, lanes per program, warps).

Exits non-zero, printing no result, when JAX finds no GPU.  The last line
of stdout is one JSON record naming the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    """`nvidia-smi` name and power limit of the first card ("" if absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
        return out.splitlines()[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _inputs(rng, groups, batch, n, m):
    from sift4g_tpu.align.xla import PAD_CODE

    m_pad = -(-m // 64) * 64
    q_all = np.full(groups * m_pad, PAD_CODE, dtype=np.int32)
    q_off = (np.arange(groups) * m_pad).astype(np.int32)
    for g in range(groups):
        q_all[g * m_pad : g * m_pad + m] = rng.integers(0, 26, m)
    return q_all, q_off, np.full(groups, m, np.int32), m_pad


def time_fn(fn, slabs, *args):
    """(compile seconds, best warm seconds, first result) of fn over
    unique pre-staged slabs; every call ends in a host fetch."""
    t0 = time.perf_counter()
    first = np.asarray(fn(slabs[0], *args))
    compile_s = time.perf_counter() - t0
    times = []
    for t in slabs[1:]:
        t0 = time.perf_counter()
        np.asarray(fn(t, *args))
        times.append(time.perf_counter() - t0)
    return compile_s, min(times), first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--m", type=int, default=360)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    from sift4g_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)

    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
    from sift4g_tpu.align.xla import _extend_matrix, align_scores_grouped_kernel
    from sift4g_tpu.core.scorers import create_scorer

    G, B, N, m = args.groups, args.batch, args.n, args.m
    rng = np.random.default_rng(42)
    q_all, q_off, q_lens, m_pad = _inputs(rng, G, B, N, m)
    qa, qo, ql = jnp.asarray(q_all), jnp.asarray(q_off), jnp.asarray(q_lens)
    lens = jnp.asarray(np.full((G, B), N, np.int32))
    m32 = jnp.asarray(_extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix))
    slabs = [
        jnp.asarray(rng.integers(0, 26, (G, B, N)).astype(np.int8))
        for _ in range(args.iters + 1)
    ]
    jax.block_until_ready(slabs)
    cells = G * B * N * m

    def kernel(t, **kw):
        return sw_scores_pallas_grouped(qa, qo, ql, t, lens, m32, **kw)

    rec = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
        "shape": {"G": G, "B": B, "N": N, "m": m},
    }
    c_s, k_s, k_first = time_fn(kernel, slabs)
    rec.update(kernel_compile_s=c_s, kernel_s=k_s,
               kernel_gcups=cells / k_s / 1e9)
    print(f"kernel: compile {c_s:.3f} s, warm {k_s * 1e3:.3f} ms, "
          f"{cells / k_s / 1e9:.3f} GCUPS", flush=True)

    def plain(t):
        return align_scores_grouped_kernel(
            qa, qo, ql, t, lens, m32, mode="SW", gap_open=10,
            gap_extend=1, m_window=m_pad,
        )

    c_x, x_s, x_first = time_fn(plain, slabs)
    rec.update(xla_compile_s=c_x, xla_s=x_s, xla_gcups=cells / x_s / 1e9,
               kernel_equals_xla=bool((k_first == x_first).all()))
    print(f"xla:    compile {c_x:.3f} s, warm {x_s * 1e3:.3f} ms, "
          f"{cells / x_s / 1e9:.3f} GCUPS, equal={rec['kernel_equals_xla']}",
          flush=True)
    if not rec["kernel_equals_xla"]:
        print("error: kernel scores differ from the XLA scan", file=sys.stderr)
        return 1
    if args.sweep:
        sweep = []
        for rows in (16, 32, 48, 64):
            for block in (128, 256):
                for warps in (4, 8):
                    if block // (32 * warps) < 1:
                        continue
                    try:
                        _, s, out = time_fn(
                            lambda t: kernel(t, rows=rows, block=block,
                                             num_warps=warps), slabs)
                        ok = bool((out == k_first).all())
                        sweep.append({"rows": rows, "block": block,
                                      "warps": warps, "s": s, "equal": ok,
                                      "gcups": cells / s / 1e9})
                    except Exception as exc:  # a variant the compiler refuses
                        sweep.append({"rows": rows, "block": block,
                                      "warps": warps, "error": str(exc)[:200]})
                    print(f"sweep: {sweep[-1]}", flush=True)
        rec["sweep"] = sweep
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

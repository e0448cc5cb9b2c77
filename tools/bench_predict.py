"""Standalone device-predict phase benchmark (synthetic prepared rows).

Isolates sift/predict_batch.py from the pipeline: generates n-query
synthetic (n_rows, L) alignment-row arrays with a realistic shape mix,
then runs predict_matrix_batch twice (cold compile + warm) and prints the
pack/fetch split.  One JAX process per card.

  python tools/bench_predict.py --n 20000 [--qchunk 64]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--qchunk", type=int, default=0,
                    help="override SIFT4G_TPU_PREDICT_QCHUNK")
    ap.add_argument("--out", default="/tmp/bench_predict_out")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.qchunk:
        os.environ["SIFT4G_TPU_PREDICT_QCHUNK"] = str(args.qchunk)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from sift4g_tpu.core.chain import Chain
    from sift4g_tpu.utils import PhaseMetrics

    rng = np.random.default_rng(7)
    queries, prepared = [], []
    for i in range(args.n):
        # realistic missense mix: most queries ~300-420 aa with ~400 rows
        L = int(rng.integers(280, 440))
        n = int(rng.integers(350, 401))
        rows = rng.integers(0, 20, size=(n, L)).astype(np.uint8)
        letters = (rows[0] + ord("A")).tobytes().decode()
        queries.append(Chain.from_string(f"q{i:05d}", letters))
        prepared.append(rows)

    os.makedirs(args.out, exist_ok=True)
    from sift4g_tpu.sift.predict_batch import predict_matrix_batch

    for tag in ("cold", "warm"):
        m = PhaseMetrics()
        t0 = time.perf_counter()
        predict_matrix_batch(queries, prepared, args.out, metrics=m)
        dt = time.perf_counter() - t0
        print(f"predict[{tag}] n={args.n} qchunk="
              f"{os.environ.get('SIFT4G_TPU_PREDICT_QCHUNK', 'auto')}: "
              f"{dt:.2f}s  "
              + "  ".join(f"{k}={v.get('seconds', 0):.2f}s"
                          for k, v in m.phases.items()),
              flush=True)


if __name__ == "__main__":
    main()

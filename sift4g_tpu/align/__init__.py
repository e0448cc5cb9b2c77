from .records import AlignmentRecord, MOVE_DIAG, MOVE_LEFT, MOVE_UP  # noqa: F401
from .dp_numpy import align_pair, score_pair  # noqa: F401


def best_backend() -> str:
    """The fastest scoring backend for this process's JAX platform.

    'pallas' on a GPU: the grouped Pallas-Triton kernel, measured far
    ahead of the plain XLA scan on an H100 (PERF.md).  On a CPU host the
    threaded C++ aligner ('native') when it is built, else the XLA scan;
    'xla' on any other platform.
    """
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        from ..native import load

        if load() is not None:
            return "native"
    return "xla"

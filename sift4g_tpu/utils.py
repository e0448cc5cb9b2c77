"""Observability: per-phase wall-clock + throughput counters.

The reference's only telemetry is carriage-return stderr meters
(utils.cpp:52-61); this adds what a production deployment needs —
structured per-phase timings and cells/s / queries/s counters — while
keeping stderr as the sink (host0-only under multi-host).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional


def env_int(name: str, default) -> int:
    """int(os.environ[name]) with an error that names the variable
    (advisor r4: a malformed knob raised a bare ValueError deep inside
    aligner init or mid-launch)."""
    raw = os.environ.get(name)
    if raw is None:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"environment variable {name}={raw!r} is not an integer"
        ) from None


# the checkout's own compile-cache directory (listed in .gitignore)
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache before the first compile.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and no other directory is set; otherwise the cache lives at
    one fixed path inside the checkout, so repeated runs from the same
    checkout hit it.  Every compile is stored, however short: JAX's default
    keeps only those over one second, and a cold pipeline run is mostly
    many shorter per-shape compiles.  Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def device_memory_bytes() -> "int | None":
    """Memory of JAX's first device, as its allocator reports it
    (``memory_stats()["bytes_limit"]``); the host's physical memory for a
    CPU device, which reports none.  None when unknown — callers then
    refuse the device path instead of assuming a size."""
    import jax

    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        try:
            return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):
            return None
    return None


def query_log(part: int, total: int, log=sys.stderr) -> None:
    """Carriage-return query progress meter (utils.cpp:52-55)."""
    print(f"* processing queries: {part}/{total} *", end="\r", file=log)
    if part == total:
        print(file=log)


def database_log(part: int, percentage: float, log=sys.stderr) -> None:
    """Carriage-return database scan meter (utils.cpp:57-61)."""
    print(
        f"* processing database part {part}: {min(percentage, 100.0):.1f}/100.0% *",
        end="\r",
        file=log,
    )


class PhaseMetrics:
    """Accumulates phase -> {seconds, counters}; printable summary."""

    def __init__(self, log=sys.stderr, enabled: bool = True):
        self.log = log
        self.enabled = enabled
        self.phases: Dict[str, Dict[str, float]] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.phases.setdefault(name, {}).setdefault("seconds", 0.0)
            self.phases[name]["seconds"] += dt

    def add(self, phase: str, **counters: float) -> None:
        d = self.phases.setdefault(phase, {})
        for k, v in counters.items():
            d[k] = d.get(k, 0.0) + v

    def rate(self, phase: str, counter: str) -> Optional[float]:
        d = self.phases.get(phase)
        if not d or not d.get("seconds"):
            return None
        v = d.get(counter)
        return None if v is None else v / d["seconds"]

    def report(self) -> None:
        if not self.enabled:
            return
        total = sum(
            d.get("seconds", 0.0)
            for name, d in self.phases.items()
            if "." not in name  # sub-timers (e.g. align.fetch) nest in a phase
        )
        print("** Phase timings **", file=self.log)
        for name, d in self.phases.items():
            parts = [f"{d.get('seconds', 0.0):8.3f}s"]
            if "cells" in d and d.get("seconds"):
                parts.append(f"{d['cells'] / d['seconds'] / 1e9:8.3f} GCUPS")
            for k, v in d.items():
                if k not in ("seconds", "cells"):
                    parts.append(f"{k}={v:g}")
            print(f"*   {name:<12} {' '.join(parts)}", file=self.log)
        print(f"*   {'total':<12} {total:8.3f}s", file=self.log)

"""Binary FASTA parse cache == direct parsers (content + part boundaries)."""

import os

import numpy as np
import pytest

from sift4g_tpu.io.fasta import (
    CachedFastaStream,
    FastaStream,
    PyFastaStream,
    build_fasta_cache,
)


@pytest.fixture(autouse=True)
def _default_cache_layout(monkeypatch):
    """These tests exercise the DEFAULT next-to-input cache layout;
    conftest redirects caches for the suite at large."""
    monkeypatch.delenv("SIFT4G_TPU_CACHE_DIR", raising=False)


def _write(tmp_path, n=37, seed=2):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        seq = "".join(chr(ord("A") + c) for c in rng.integers(0, 26, rng.integers(3, 120)))
        recs.append(f">s{i} desc\n{seq}\n")
    p = tmp_path / "db.fa"
    p.write_text("".join(recs))
    return str(p)


def test_cache_matches_parser(tmp_path):
    path = _write(tmp_path)
    cp = build_fasta_cache(path)
    assert os.path.exists(cp)

    for budget in (1, 97, 5000, 1 << 40):
        ref_parts, got_parts = [], []
        with PyFastaStream(path) as fs:
            more = True
            while more:
                chains = []
                more = fs.read_part(chains, budget)
                ref_parts.append([(c.name, c.codes.tobytes()) for c in chains])
        with CachedFastaStream(cp) as fs:
            more = True
            while more:
                chains = []
                more = fs.read_part(chains, budget)
                got_parts.append([(c.name, c.codes.tobytes()) for c in chains])
        assert got_parts == ref_parts, f"budget={budget}"


def test_factory_prefers_cache_and_invalidates(tmp_path):
    path = _write(tmp_path)
    s = FastaStream(path)
    assert isinstance(s, CachedFastaStream)
    s.close()
    # stale cache (input newer) must be rebuilt
    cache = path + ".s4gc"
    old_mtime = os.path.getmtime(cache)
    os.utime(cache, (old_mtime - 10, old_mtime - 10))  # make cache look old
    stale_mtime = os.path.getmtime(cache)
    s2 = FastaStream(path)
    assert isinstance(s2, CachedFastaStream)
    assert os.path.getmtime(cache) > stale_mtime, "cache was not rebuilt"
    chains = []
    while s2.read_part(chains, 1 << 40):
        pass
    assert len(chains) == 37


def test_cache_dir_override_readonly_input(tmp_path, monkeypatch):
    """SIFT4G_TPU_CACHE_DIR: a database in a read-only directory gets a
    working cache under the override, and nothing is written next to the
    input (no .s4gc droppings in shared input dirs)."""
    src = tmp_path / "ro"
    src.mkdir()
    path = _write(src)
    cache_dir = tmp_path / "cache"
    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(cache_dir))
    os.chmod(src, 0o555)
    try:
        s = FastaStream(path)
        assert isinstance(s, CachedFastaStream)
        chains = []
        while s.read_part(chains, 1 << 40):
            pass
        s.close()
        assert len(chains) == 37
        # the cache landed in the override dir, keyed by basename+hash
        cached = [f for f in os.listdir(cache_dir) if f.endswith(".s4gc")]
        assert len(cached) == 1 and cached[0].startswith("db.fa.")
        # the input directory stayed pristine
        assert sorted(os.listdir(src)) == ["db.fa"]
    finally:
        os.chmod(src, 0o755)


def test_cache_dir_override_distinct_inputs_do_not_collide(tmp_path, monkeypatch):
    """Two same-basename databases in different directories get distinct
    cache files under the override."""
    from sift4g_tpu.io.fasta import _cache_path

    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    pa = _write(a, n=5, seed=1)
    pb = _write(b, n=7, seed=2)
    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / "cache"))
    assert _cache_path(pa) != _cache_path(pb)
    for p, n in ((pa, 5), (pb, 7)):
        s = FastaStream(p)
        assert isinstance(s, CachedFastaStream)
        chains = []
        while s.read_part(chains, 1 << 40):
            pass
        s.close()
        assert len(chains) == n

"""FASTA input: full-file reads and byte-budget chunked streaming.

Mirrors the swsharp capabilities the reference relies on
(``readFastaChains`` at reference main.cpp:192; ``readFastaChainsPartInit``
+ ``readFastaChainsPart`` streaming at database_search.cpp:81-97 and
database_alignment.cpp:36-48): the streaming reader appends chains to a
growing list so global database indices stay stable across chunks, and
returns EOF status once the file is exhausted.

The chunk budget counts residue bytes (sequence characters kept), which is
the dominant term of the reference's on-disk chunk accounting (~250MB
search chunks, database_search.cpp:17; ~1GB alignment chunks,
database_alignment.cpp:12).

Parsing rules:
* header name = first whitespace-delimited token after '>'
  (subst files are keyed by it, sift_prediction.cpp:99);
* sequence letters are upcased; non-alphabetic characters are dropped.

A native C++ parser (sift4g_tpu/native) accelerates bulk parsing when the
shared library is built; this module falls back to pure Python otherwise.
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple

import numpy as np

from ..core.chain import Chain

_UPPER_KEEP = np.full(256, 255, dtype=np.uint8)
for _c in range(ord("A"), ord("Z") + 1):
    _UPPER_KEEP[_c] = _c - ord("A")
    _UPPER_KEEP[_c + 32] = _c - ord("A")  # lowercase


def _codes_from_bytes(seq: bytes) -> np.ndarray:
    arr = _UPPER_KEEP[np.frombuffer(seq, dtype=np.uint8)]
    return arr[arr != 255]


class PyFastaStream:
    """Incremental FASTA reader with a residue-byte budget per part.

    ``read_part(chains, max_bytes)`` appends newly parsed chains to
    ``chains`` and returns False once EOF has been reached (mirroring
    swsharp ``readFastaChainsPart`` returning 0 at EOF).
    """

    def __init__(self, path: str, buffer_size: int = 1 << 22,
                 record_range: Optional[Tuple[int, int]] = None):
        self._fh = open(path, "rb")
        self._buffered = io.BufferedReader(self._fh, buffer_size)
        self._pending_name: Optional[str] = None
        self._pending_parts: List[bytes] = []
        self._eof = False
        # multi-host shard: emit only records with index in [lo, hi)
        self._lo, self._hi = record_range if record_range else (0, 1 << 62)
        self._rec = -1  # index of the record currently being accumulated

    def close(self) -> None:
        self._buffered.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _emit(self, chains: List[Chain]) -> int:
        name = self._pending_name
        codes = _codes_from_bytes(b"".join(self._pending_parts))
        self._pending_parts = []
        self._pending_name = None
        chains.append(Chain(name=name, codes=codes))
        return int(codes.shape[0])

    def read_part(self, chains: List[Chain], max_bytes: int) -> bool:
        """Parse until ~max_bytes residues were appended. Returns False at EOF."""
        if self._eof:
            return False
        budget = max_bytes
        for raw in self._buffered:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if self._pending_name is not None:
                    budget -= self._emit(chains)
                self._rec += 1
                if self._rec >= self._hi:
                    self._eof = True
                    return False
                if self._rec < self._lo:
                    self._pending_name = None  # out-of-shard: skip record
                    continue
                header = line[1:].decode("utf-8", errors="replace").strip()
                self._pending_name = header.split()[0] if header else ""
                if budget <= 0:
                    return True
            else:
                if self._pending_name is not None:
                    self._pending_parts.append(line)
        # EOF
        if self._pending_name is not None:
            self._emit(chains)
        self._eof = True
        return False

    def read_part_arrays(self, max_residues: int):
        """Array-form part (more, codes, offsets, names) — adapter over
        read_part so every stream kind supports the zero-object fast path."""
        chains: List[Chain] = []
        more = self.read_part(chains, max_residues)
        lengths = [c.codes.shape[0] for c in chains]
        offsets = np.zeros(len(chains) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        codes = (
            np.concatenate([c.codes for c in chains])
            if chains
            else np.zeros(0, np.uint8)
        )
        return more, codes, offsets, [c.name for c in chains]


class NativeFastaStream:
    """Native (C++) streaming parser — same part semantics as PyFastaStream.

    Additionally exposes :meth:`read_part_arrays`, the zero-object fast
    path used by the native prefilter: packed codes + offsets + names for
    one part, with no per-sequence Python work.
    """

    def __init__(self, path: str, lib=None):
        from .. import native as _native

        self._lib = lib or _native.load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.sift4g_fasta_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def close(self) -> None:
        if self._h:
            self._lib.sift4g_fasta_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_part_arrays(self, max_residues: int):
        """-> (more, codes (R,) u8, offsets (n+1,) i64, names list[str])"""
        import ctypes

        lib = self._lib
        more = lib.sift4g_fasta_read_part(self._h, max_residues)
        nseq = lib.sift4g_fasta_part_nseq(self._h)
        residues = lib.sift4g_fasta_part_residues(self._h)
        nbytes = lib.sift4g_fasta_part_names_bytes(self._h)
        codes = np.empty(residues, dtype=np.uint8)
        offsets = np.empty(nseq + 1, dtype=np.int64)
        names_buf = ctypes.create_string_buffer(max(int(nbytes), 1))
        name_offsets = np.empty(nseq + 1, dtype=np.int64)
        lib.sift4g_fasta_part_fill(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            names_buf,
            name_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        raw = names_buf.raw[:nbytes]
        names = [
            raw[name_offsets[i] : name_offsets[i + 1]].decode("utf-8", "replace")
            for i in range(nseq)
        ]
        return bool(more), codes, offsets, names

    def read_part(self, chains: List[Chain], max_bytes: int) -> bool:
        more, codes, offsets, names = self.read_part_arrays(max_bytes)
        for i, name in enumerate(names):
            # copy, so freeing one chain never pins the whole part buffer
            chains.append(
                Chain(name=name, codes=codes[offsets[i] : offsets[i + 1]].copy())
            )
        return more


class CachedFastaStream:
    """Streams parts from a binary parse cache (.s4gc) — the analogue of
    swsharp's serialized FASTA dump (SURVEY.md §2.2: readFastaChainsPart's
    ``serialized`` flag memoizes parsing next to the input).

    The cache holds packed codes + offsets + newline-joined names; parts
    honor the same residue-budget boundary semantics as the parsers (a part
    ends with the sequence that exhausts the budget).
    """

    MAGIC = b"S4GC0003"

    def __init__(self, path: str, record_range: Optional[Tuple[int, int]] = None):
        # layout: MAGIC(8) | n_codes u64 | raw u8 codes | npy(offsets) |
        # npy(names blob).  The codes payload is raw bytes at a fixed
        # offset (16) — memory-mapped, so a UniRef90-scale cache costs no
        # resident memory until its chunks are touched, and no numpy
        # header parsing (public or private) is involved.
        with open(path, "rb") as fh:
            if fh.read(8) != self.MAGIC:
                raise ValueError("bad cache magic")
            n_codes = int.from_bytes(fh.read(8), "little")
            data_off = fh.tell()
            self._codes = (
                np.memmap(path, dtype=np.uint8, mode="r", offset=data_off,
                          shape=(n_codes,))
                if n_codes
                else np.zeros(0, np.uint8)
            )
            fh.seek(data_off + n_codes)
            self._offsets = np.load(fh, allow_pickle=False)
            names_blob = np.load(fh, allow_pickle=False)
        self._names = bytes(names_blob).decode("utf-8").split("\n") if names_blob.size else []
        n = self._offsets.shape[0] - 1
        if len(self._names) < n:  # all-empty-name edge: join/split collapses
            self._names += [""] * (n - len(self._names))
        # multi-host shard: serve only records [lo, hi) (seek is free — the
        # cache is an offsets array over mmap-backed codes)
        self._lo, self._hi = record_range if record_range else (0, n)
        self._hi = min(self._hi, n)
        self._pos = self._lo

    @classmethod
    def write_cache(cls, cache_path: str, codes, offsets, names) -> None:
        with CacheWriter(cache_path) as w:
            w.add_part(codes, np.diff(offsets), names)

    def n_sequences(self) -> int:
        return self._offsets.shape[0] - 1

    def codes_at(self, idx: int) -> np.ndarray:
        """Random access (zero-copy mmap view) — the overlapped pipeline's
        end-of-run traceback fetches only the winners' codes this way."""
        return self._codes[self._offsets[idx] : self._offsets[idx + 1]]

    def name_at(self, idx: int) -> str:
        return self._names[idx]

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_part_arrays(self, max_residues: int):
        n = self._hi
        start = self._pos
        # part boundary: include records while the residue budget is > 0,
        # i.e. stop at the first i with offsets[i] - offsets[start] >=
        # max_residues (the record that exhausts the budget is included) —
        # same semantics as the per-record loop of the parsers, found
        # vectorized (a Python loop here cost ~0.35 s per 256 MB part at
        # UniRef90 scale, serializing against the native scan)
        i = int(
            np.searchsorted(
                self._offsets, self._offsets[start] + max_residues, side="left"
            )
        )
        i = max(start + 1, min(i, n))
        if start >= n:
            i = start
        self._pos = i
        base = self._offsets[start]
        codes = self._codes[base : self._offsets[i]]
        offsets = (self._offsets[start : i + 1] - base).astype(np.int64)
        names = self._names[start:i]
        return i < n, codes, offsets, names

    def read_part(self, chains: List[Chain], max_bytes: int) -> bool:
        more, codes, offsets, names = self.read_part_arrays(max_bytes)
        for k, name in enumerate(names):
            chains.append(
                Chain(name=name, codes=codes[offsets[k] : offsets[k + 1]].copy())
            )
        return more


class CacheWriter:
    """Streaming .s4gc writer: code parts are appended as they are parsed
    (never materializing the whole database in RAM — a first run on a
    bigger-than-memory database stays bounded); the code byte count is
    patched into the fixed-offset header on close.  Offsets (8 bytes/seq)
    and names stay in RAM — trivial next to the codes."""

    def __init__(self, cache_path: str):
        self._final = cache_path
        # pid suffix: concurrent builders (multi-host processes sharing a
        # filesystem) must not clobber each other's partial writes; the
        # os.replace on close stays atomic either way
        self._tmp = f"{cache_path}.tmp.{os.getpid()}"
        self._fh = open(self._tmp, "wb")
        self._fh.write(CachedFastaStream.MAGIC)
        self._fh.write((0).to_bytes(8, "little"))  # patched on close
        self._n_codes = 0
        self._lengths: List[np.ndarray] = []
        self._names: List[str] = []

    def add_part(self, codes: np.ndarray, lengths, names) -> None:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self._fh.write(codes.tobytes())
        self._n_codes += int(codes.shape[0])
        self._lengths.append(np.asarray(lengths, dtype=np.int64))
        self._names.extend(names)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            self._fh.close()
            os.unlink(self._tmp)
            return False
        self.close()
        return False

    def close(self) -> None:
        lengths = (
            np.concatenate(self._lengths) if self._lengths else np.zeros(0, np.int64)
        )
        offsets = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        np.save(self._fh, offsets)
        blob = "\n".join(self._names).encode("utf-8")
        np.save(self._fh, np.frombuffer(blob, dtype=np.uint8))
        self._fh.seek(8)
        self._fh.write(self._n_codes.to_bytes(8, "little"))
        self._fh.close()
        os.replace(self._tmp, self._final)


class ChunkStore:
    """Sequence access over streamed parts with NO per-sequence objects.

    Building millions of Chain objects dominates large-database align
    phases (measured: ~15 s for 2M sequences); the store keeps each part's
    packed codes + offsets (mmap-backed when the parse cache is in use)
    and serves code slices / names by global index.
    """

    def __init__(self, start: int = 0):
        # ``start``: global index of the first appended record (nonzero for
        # multi-host database shards, mirroring the chunk-offset bookkeeping
        # of reference database_search.cpp:208)
        self._parts = []   # (codes, offsets, names, global_start)
        self.count = start

    def append_part(self, codes, offsets, names) -> None:
        self._parts.append((codes, offsets, names, self.count))
        self.count += len(names)

    def _locate(self, idx: int):
        for part in reversed(self._parts):   # few parts; newest first
            if idx >= part[3]:
                return part
        raise IndexError(idx)

    def codes(self, idx: int) -> np.ndarray:
        codes, offsets, _, start = self._locate(idx)
        k = idx - start
        return codes[offsets[k] : offsets[k + 1]]

    def name(self, idx: int) -> str:
        _, _, names, start = self._locate(idx)
        return names[idx - start]

    @property
    def latest_is_mmap(self) -> bool:
        """True when the newest part's codes are cache-mmap-backed (free to
        keep around); heap-backed parts must be evicted once consumed."""
        if not self._parts:
            return False
        codes = self._parts[-1][0]
        return isinstance(codes, np.memmap) or isinstance(
            getattr(codes, "base", None), np.memmap
        )

    def drop_before_latest(self) -> None:
        """Free all parts except the newest.  The align chunk loop consumes
        candidate indices in ascending order, so older parts are never read
        again; without eviction heap-backed parts (no parse cache) would pin
        the whole database in RAM for the entire align phase."""
        del self._parts[:-1]

    def pack_latest(self, idxs):
        """(codes, starts, lens) arrays for indices inside the NEWEST part,
        or None if any index falls outside it (callers then fall back to
        per-index access).  The align chunk loop consumes candidates in
        ascending order, so each iteration's indices live in the newest
        part by construction."""
        codes, offsets, _, start = self._parts[-1]
        local = np.asarray(idxs, dtype=np.int64) - start
        if local.size and (local.min() < 0 or local.max() >= offsets.shape[0] - 1):
            return None
        starts = offsets[local]
        lens = (offsets[local + 1] - starts).astype(np.int32)
        return codes, starts, lens


def _cache_path(path: str) -> str:
    """Where the parse cache for ``path`` lives.

    Default: next to the input (the layout swsharp's serialized cache
    role implies, database_search.cpp:80-82).  SIFT4G_TPU_CACHE_DIR
    redirects all caches into one owned directory — read-only input
    directories get a working cache, and shared/reference database
    directories are never polluted.  The filename
    hashes the absolute path + size + mtime so distinct databases (and
    distinct versions of one) can never collide."""
    cache_dir = os.environ.get("SIFT4G_TPU_CACHE_DIR")
    if not cache_dir:
        return path + ".s4gc"
    import hashlib

    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
        tag = f"{ap}:{st.st_size}:{st.st_mtime_ns}"
    except OSError:
        tag = ap
    h = hashlib.sha1(tag.encode()).hexdigest()[:16]
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{os.path.basename(path)}.{h}.s4gc")


def build_fasta_cache(path: str) -> str:
    """Parse once, streaming parts straight into the binary cache next to
    the input (bounded memory regardless of database size); returns the
    cache path.  Uses the native parser when available."""
    from .. import native as _native

    lib = _native.load()
    stream = (
        NativeFastaStream(path, lib=lib) if lib is not None else PyFastaStream(path)
    )
    cp = _cache_path(path)
    with stream as fs, CacheWriter(cp) as w:
        more = True
        while more:
            more, codes, offsets, names = fs.read_part_arrays(1 << 28)
            w.add_part(codes, np.diff(offsets), names)
    return cp


def FastaStream(path: str, buffer_size: int = 1 << 22, use_cache: bool = True,
                record_range: Optional[Tuple[int, int]] = None):
    """Open a streaming FASTA reader.

    Preference order: fresh binary parse cache (one-time cost amortized —
    the pipeline streams the database twice per run, search then align) >
    native C++ parser > pure Python.

    ``record_range=(lo, hi)`` serves only that record-index slice — the
    multi-host database shard (docs/MULTIHOST.md).  Free seek with the
    cache; the Python parser skims and skips otherwise.
    """
    if use_cache and not os.environ.get("SIFT4G_TPU_NO_FASTA_CACHE"):
        cp = _cache_path(path)
        try:
            if not (
                os.path.exists(cp)
                and os.path.getmtime(cp) >= os.path.getmtime(path)
            ):
                build_fasta_cache(path)
            try:
                return CachedFastaStream(cp, record_range=record_range)
            except ValueError:
                # stale format (magic mismatch): rebuild once
                build_fasta_cache(path)
                return CachedFastaStream(cp, record_range=record_range)
        except (OSError, ValueError):
            pass  # unwritable directory / corrupt cache: stream directly
    if record_range is None:
        from .. import native as _native

        lib = _native.load()
        if lib is not None:
            try:
                return NativeFastaStream(path, lib=lib)
            except FileNotFoundError:
                raise
            except RuntimeError:
                pass
    return PyFastaStream(path, buffer_size, record_range=record_range)


def read_fasta(path: str) -> List[Chain]:
    """Read the whole file (mirror of ``readFastaChains``, main.cpp:192)."""
    chains: List[Chain] = []
    with FastaStream(path) as fs:
        while fs.read_part(chains, 1 << 62):
            pass
    return chains


def read_fasta_total_residues(path: str) -> Tuple[List[Chain], int]:
    chains = read_fasta(path)
    return chains, sum(len(c) for c in chains)

"""ctypes bindings for the native runtime (libsift4g_native.so).

The native layer provides the host-side components the reference
implements in C/C++ (swsharp FASTA streaming; sift4g's pthread prefilter
hot loop, database_search.cpp:185-253): a streaming FASTA parser and the
k-mer/LIS/top-k search engine.  Pure-Python fallbacks exist for both
(io/fasta.py, prefilter/search.py); callers use :func:`load` and fall back
when it returns None.

The shared library is built on first use if a compiler is available
(``make -C sift4g_tpu/native``); ``python -m sift4g_tpu.native`` builds it
explicitly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libsift4g_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

c_i64 = ctypes.c_int64
c_i32 = ctypes.c_int32
c_u8_p = ctypes.POINTER(ctypes.c_uint8)
c_i64_p = ctypes.POINTER(ctypes.c_int64)
c_i32_p = ctypes.POINTER(ctypes.c_int32)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sift4g_search_create.restype = ctypes.c_void_p
    lib.sift4g_search_create.argtypes = [
        c_i32, c_i32, c_i32, c_i32_p, c_i64, c_i32_p, c_i32_p, c_i64, c_i32,
    ]
    lib.sift4g_search_chunk.restype = ctypes.c_uint64
    lib.sift4g_search_chunk.argtypes = [
        ctypes.c_void_p, c_u8_p, c_i64_p, c_i64, c_i64,
    ]
    lib.sift4g_search_counts.restype = None
    lib.sift4g_search_counts.argtypes = [ctypes.c_void_p, c_i64_p]
    lib.sift4g_search_collect.restype = None
    lib.sift4g_search_collect.argtypes = [ctypes.c_void_p, c_i64_p]
    lib.sift4g_search_destroy.restype = None
    lib.sift4g_search_destroy.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "sift4g_search_collect_scored"):  # stale .so tolerance
        lib.sift4g_search_collect_scored.restype = None
        lib.sift4g_search_collect_scored.argtypes = [
            ctypes.c_void_p, c_i64_p, ctypes.POINTER(ctypes.c_float),
        ]
    if hasattr(lib, "sift4g_hash_count"):  # stale .so tolerance
        lib.sift4g_hash_count.restype = c_i64
        lib.sift4g_hash_count.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), c_i64_p, c_i64, ctypes.c_int,
            c_i32_p, c_i64,
        ]
        lib.sift4g_hash_fill.restype = None
        lib.sift4g_hash_fill.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), c_i64_p, c_i64, ctypes.c_int,
            c_i32_p, c_i64, c_i32_p, c_i32_p,
        ]
    if hasattr(lib, "sift4g_search_stats"):  # stale .so tolerance
        lib.sift4g_search_stats.restype = None
        lib.sift4g_search_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ]

    lib.sift4g_fasta_open.restype = ctypes.c_void_p
    lib.sift4g_fasta_open.argtypes = [ctypes.c_char_p]
    lib.sift4g_fasta_read_part.restype = ctypes.c_int
    lib.sift4g_fasta_read_part.argtypes = [ctypes.c_void_p, c_i64]
    for fn in ("part_nseq", "part_residues", "part_names_bytes"):
        f = getattr(lib, f"sift4g_fasta_{fn}")
        f.restype = c_i64
        f.argtypes = [ctypes.c_void_p]
    lib.sift4g_fasta_part_fill.restype = None
    lib.sift4g_fasta_part_fill.argtypes = [
        ctypes.c_void_p, c_u8_p, c_i64_p, ctypes.c_char_p, c_i64_p,
    ]
    lib.sift4g_fasta_close.restype = None
    lib.sift4g_fasta_close.argtypes = [ctypes.c_void_p]

    lib.sift4g_pack_group.restype = None
    lib.sift4g_pack_group.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), c_i32_p, c_i32, c_i64,
        ctypes.POINTER(ctypes.c_int8), c_i32_p,
    ]

    lib.sift4g_align_batch.restype = ctypes.c_int
    lib.sift4g_align_batch.argtypes = [
        c_u8_p, c_i32, c_u8_p, c_i64_p, c_i32,   # q, qlen, targets, offsets, n
        c_i32_p, c_i32, c_i32, c_i32, c_i32,      # matrix26, go, ge, mode, threads
        c_i32_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p,  # score, qs, qe, ts, te
        c_u8_p, c_i64, c_i64_p,                   # moves_buf, cap, moves_off
    ]

    if hasattr(lib, "sift4g_score_batch"):  # stale .so tolerance
        lib.sift4g_score_batch.restype = None
        lib.sift4g_score_batch.argtypes = [
            c_u8_p, c_i32, c_u8_p,                   # q, qlen, codes base
            c_i64_p, c_i32_p, c_i32,                 # starts, lens, n
            c_i32_p, c_i32, c_i32, c_i32, c_i32,     # matrix26, go, ge, mode, threads
            c_i32_p,                                 # out scores
        ]

    if hasattr(lib, "sift4g_select"):  # stale .so tolerance
        lib.sift4g_select.restype = c_i64
        lib.sift4g_select.argtypes = [
            c_u8_p, c_i64, c_i64,                    # rows, n, L
            ctypes.POINTER(ctypes.c_float), c_i64,   # xlogx table, size
            ctypes.c_float, ctypes.c_double,         # threshold, kLog_2_20
        ]
    _extract_sig = [
        c_u8_p, c_i64_p,                         # moves, move offsets (n+1)
        c_i64_p, c_i64_p,                        # query/target starts
        c_u8_p, c_i64_p,                         # tcodes, tcode offsets (n+1)
        c_i64, c_i64, c_u8_p,                    # n, L, rows out (X-filled)
    ]
    if hasattr(lib, "sift4g_extract"):  # stale .so tolerance
        lib.sift4g_extract.restype = None
        lib.sift4g_extract.argtypes = _extract_sig
    if hasattr(lib, "sift4g_basic_matrix"):
        lib.sift4g_basic_matrix.restype = c_i64
        lib.sift4g_basic_matrix.argtypes = [
            c_u8_p, c_i64_p, c_i64, c_i64,           # rows, keep, m, L
            ctypes.POINTER(ctypes.c_double), c_u8_p,  # aa_freq, valid mask
            ctypes.POINTER(ctypes.c_double),          # out (L, 26)
        ]
    if hasattr(lib, "sift4g_seq_weights"):
        lib.sift4g_seq_weights.restype = c_i64
        lib.sift4g_seq_weights.argtypes = [
            c_u8_p, c_i64, c_i64, c_u8_p,             # rows, n, L, valid
            ctypes.POINTER(ctypes.c_double),          # out w (n,)
            ctypes.POINTER(ctypes.c_double),          # out ndiff (L,)
        ]
    if hasattr(lib, "sift4g_extract_checked"):
        # returns -1 or the first corrupt record's index (callers raise)
        lib.sift4g_extract_checked.restype = c_i64
        lib.sift4g_extract_checked.argtypes = _extract_sig
    return lib


def build() -> bool:
    """Compile the shared library; returns True on success."""
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=300,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _stale() -> bool:
    """True when any source is newer than the built .so (a rebuild is
    needed; the hasattr guards in _bind only cover ADDED symbols, not
    changed semantics)."""
    try:
        so_mtime = os.path.getmtime(_LIB_PATH)
        return any(
            os.path.getmtime(os.path.join(_DIR, f)) > so_mtime
            for f in os.listdir(_DIR)
            if f.endswith((".cpp", ".hpp")) or f == "Makefile"
        )
    except OSError:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The bound native library, building it on first use; None if unavailable.

    Set SIFT4G_TPU_NO_NATIVE=1 to force the pure-Python fallbacks.
    """
    global _lib, _tried
    if os.environ.get("SIFT4G_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or _stale():
            if not build() and not os.path.exists(_LIB_PATH):
                return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except OSError:
            _lib = None
        return _lib

"""Sequence data model.

The reference keeps per-sequence ``Chain`` objects with a letter view and an
integer-code view (swsharp ``chainGetChar`` / ``chainGetCodes``, see call
sites at reference hash.cpp:25,30 and select_alignments.cpp:208).  Here a
:class:`Chain` is a lightweight host object whose codes are a NumPy ``uint8``
array (code = letter - 'A', 0..25), and :class:`ChainBatch` is the padded
device-friendly batch view (codes matrix + lengths) used by the device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Code assigned to padding slots in batched code arrays.  31 is outside the
# 0..25 alphabet and fits in 5 bits.
PAD_CODE = 31


@dataclass
class Chain:
    """One named protein sequence.

    ``name`` is the first whitespace-delimited token of the FASTA header
    (the reference keys .subst files by it, sift_prediction.cpp:99).
    ``codes`` are uint8 values ``letter - 'A'`` for uppercase letters A..Z.
    """

    name: str
    codes: np.ndarray  # uint8, values 0..25

    def __post_init__(self):
        self.codes = np.ascontiguousarray(self.codes, dtype=np.uint8)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @classmethod
    def from_string(cls, name: str, seq: str) -> "Chain":
        """Build from a residue string; keeps only alphabetic chars, upcased."""
        filtered = [c for c in seq.upper() if "A" <= c <= "Z"]
        codes = np.frombuffer("".join(filtered).encode("ascii"), dtype=np.uint8) - ord("A")
        return cls(name, codes)

    @property
    def letters(self) -> str:
        return (self.codes + ord("A")).tobytes().decode("ascii")

    def char(self, idx: int) -> str:
        return chr(int(self.codes[idx]) + ord("A"))


@dataclass
class ChainBatch:
    """Padded batch of sequences for device kernels.

    ``codes``: (B, Lpad) int32, PAD_CODE in padding slots.
    ``lengths``: (B,) int32 true lengths.
    ``indices``: (B,) int64 global ids of the member chains (e.g. database
    indices), so shard-local results can be merged globally.
    """

    codes: np.ndarray
    lengths: np.ndarray
    indices: np.ndarray = field(default=None)

    @classmethod
    def from_chains(cls, chains, pad_to: int | None = None,
                    multiple_of: int = 128, indices=None) -> "ChainBatch":
        n = len(chains)
        max_len = max((len(c) for c in chains), default=0)
        if pad_to is None:
            pad_to = max(max_len, 1)
        pad_to = -(-pad_to // multiple_of) * multiple_of
        codes = np.full((n, pad_to), PAD_CODE, dtype=np.int32)
        lengths = np.zeros((n,), dtype=np.int32)
        for i, c in enumerate(chains):
            codes[i, : len(c)] = c.codes
            lengths[i] = len(c)
        if indices is None:
            indices = np.arange(n, dtype=np.int64)
        return cls(codes=codes, lengths=lengths, indices=np.asarray(indices, np.int64))

    def __len__(self) -> int:
        return int(self.codes.shape[0])

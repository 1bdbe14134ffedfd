"""ReadBatch: the padded-tensor record model.

The reference processes one record at a time through a ``FASTX`` struct of
C string buffers (FASTX-Toolkit src/libfastx/fastx.h:62-117).  Here a
whole batch of reads is one structure of fixed-shape arrays so that every
per-read loop of the reference becomes a single vectorized transform:

* ``bases   uint8 [B, L]`` — raw ASCII nucleotide bytes (so arbitrary mask
  characters and case survive untouched); padded with 0 beyond ``lengths``.
* ``quals   int8  [B, L]`` — numeric quality values (range -15..93, the
  reference's MIN/MAX_QUALITY_VALUE, fastx.h:28-29); 0 in padding.
* ``lengths int32 [B]``    — per-read sequence length.
* ``counts  int32 [B]``    — collapsed-read multiplicity parsed from the
  sequence id (``get_reads_count``, fastx.c:475-495); always 1 for FASTQ.

Host-side (never shipped to device): the id strings (``names``/``names2``)
kept as one flat uint8 buffer + offsets so renaming/rendering stays
vectorized, plus per-record format flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class BaseCode:
    """Lookup tables over raw ASCII base bytes (bases stay as bytes end to
    end; 0 is the PAD byte)."""

    PAD = 0

    # byte -> reverse-complement byte (fastx_reverse_complement.c:43-72):
    # A<->T, C<->G, N->N, same for lowercase; any other byte maps to 0,
    # which the revcomp op treats as "invalid nucleotide" (the reference
    # errx's there).
    COMPLEMENT = np.zeros(256, dtype=np.uint8)
    for _src, _dst in zip(b"ATGCatgcNn", b"TACGtacgNn"):
        COMPLEMENT[_src] = _dst

    # byte -> quality-stats nucleotide slot (fastx_quality_stats.c:139-153):
    # ALL=0, A=1, C=2, G=3, T=4, N=5; unknown bytes land in ALL (slot 0),
    # mirroring the reference's zero-initialized nuc_to_index table.
    STATS_INDEX = np.zeros(256, dtype=np.int8)
    for _i, _pair in enumerate((b"Aa", b"Cc", b"Gg", b"Tt", b"Nn")):
        for _ch in _pair:
            STATS_INDEX[_ch] = _i + 1


def _flat_strings(strings) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of bytes into (flat uint8 buffer, int64 offsets[B+1])."""
    offs = np.zeros(len(strings) + 1, dtype=np.int64)
    for i, s in enumerate(strings):
        offs[i + 1] = offs[i] + len(s)
    buf = np.empty(offs[-1], dtype=np.uint8)
    for i, s in enumerate(strings):
        buf[offs[i] : offs[i + 1]] = np.frombuffer(s, dtype=np.uint8)
    return buf, offs


@dataclasses.dataclass
class StringColumn:
    """A column of B variable-length byte strings, stored flat."""

    buf: np.ndarray  # uint8 [total]
    offs: np.ndarray  # int64 [B+1]

    @classmethod
    def from_list(cls, strings) -> "StringColumn":
        buf, offs = _flat_strings(strings)
        return cls(buf, offs)

    def __len__(self) -> int:
        return len(self.offs) - 1

    def lengths(self) -> np.ndarray:
        return (self.offs[1:] - self.offs[:-1]).astype(np.int64)

    def get(self, i: int) -> bytes:
        return self.buf[self.offs[i] : self.offs[i + 1]].tobytes()

    def to_list(self) -> list:
        return [self.get(i) for i in range(len(self))]

    def max_len(self) -> int:
        return int(self.lengths().max()) if len(self) else 0

    def padded(self, width: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        """Return ([B, W] uint8 matrix, lengths) right-padded with zeros."""
        n = len(self)
        lens = self.lengths()
        w = int(width if width is not None else (lens.max() if n else 0))
        out = np.zeros((n, w), dtype=np.uint8)
        if n and w:
            col = np.arange(w, dtype=np.int64)
            idx = self.offs[:-1, None] + col[None, :]
            mask = col[None, :] < lens[:, None]
            out[mask] = self.buf[idx[mask]]
        return out, lens.astype(np.int32)

    def take(self, indices: np.ndarray) -> "StringColumn":
        """Gather a subset/reordering of rows (vectorized)."""
        lens = self.lengths()[indices]
        new_offs = np.zeros(len(indices) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_offs[1:])
        new_buf = np.empty(new_offs[-1], dtype=np.uint8)
        if new_offs[-1]:
            # positions: for each output row, range of source bytes
            src_starts = self.offs[:-1][indices]
            w = int(lens.max()) if len(lens) else 0
            col = np.arange(w, dtype=np.int64)
            mask = col[None, :] < lens[:, None]
            src = (src_starts[:, None] + col[None, :])[mask]
            new_buf[:] = self.buf[src]
        return StringColumn(new_buf, new_offs)

    @classmethod
    def from_padded(cls, mat: np.ndarray, lens: np.ndarray) -> "StringColumn":
        """Inverse of :meth:`padded` (mask-flatten, vectorized)."""
        n, w = mat.shape
        lens = lens.astype(np.int64)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        col = np.arange(w, dtype=np.int64)
        mask = col[None, :] < lens[:, None]
        return cls(mat[mask].astype(np.uint8), offs)


@dataclasses.dataclass
class ReadBatch:
    """A batch of reads: device-able arrays + host-side id strings."""

    bases: np.ndarray  # uint8 [B, L] (raw ASCII bytes, 0 = PAD)
    quals: np.ndarray  # int8 [B, L]
    lengths: np.ndarray  # int32 [B]
    counts: np.ndarray  # int32 [B]

    names: StringColumn  # id line without the '>'/'@' prefix
    names2: Optional[StringColumn]  # FASTQ 3rd line without '+'; None for FASTA

    is_fastq: bool
    # per-record: True if the input quality line was ASCII-encoded
    # (fastx.c:382-390 decides by len(qual)==len(seq))
    qual_ascii: Optional[np.ndarray] = None  # bool [B]

    def __len__(self) -> int:
        return int(self.bases.shape[0])

    @property
    def width(self) -> int:
        return int(self.bases.shape[1])

    def select(self, keep: np.ndarray) -> "ReadBatch":
        """Keep the rows where ``keep`` is True (host-side)."""
        keep = np.asarray(keep, dtype=bool)
        idx = np.nonzero(keep)[0]
        return self.take(idx)

    def take(self, idx: np.ndarray) -> "ReadBatch":
        return ReadBatch(
            bases=np.asarray(self.bases)[idx],
            quals=np.asarray(self.quals)[idx],
            lengths=np.asarray(self.lengths)[idx],
            counts=np.asarray(self.counts)[idx],
            names=self.names.take(idx),
            names2=self.names2.take(idx) if self.names2 is not None else None,
            is_fastq=self.is_fastq,
            qual_ascii=(
                np.asarray(self.qual_ascii)[idx] if self.qual_ascii is not None else None
            ),
        )

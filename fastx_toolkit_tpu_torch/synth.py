"""Seeded synthetic FASTQ lanes for smoke runs and tests.

:func:`synth_lane_bytes` is the generator of the repository's C-baseline
lane (``bench.synth_lane_bytes``), rebuilt on the port's own ``records``
and ``codec``: with the default adapter it gives the same bytes.
:func:`synth_small_rna_lane_bytes` is a small-RNA lane for the standalone
clipper (``fastx_clipper -a TGGAATTCTCGGGTGCCAAGG -l 15 -c``);
:func:`synth_collapse_lane_bytes` a clipped small-RNA lane with the
duplication of miRNA-seq, for ``fastx_collapser``;
:func:`synth_barcode_lane_bytes` a multiplexed lane with inline barcodes
and its barcode file, for ``fastx_barcode_splitter``.
"""

from __future__ import annotations

import numpy as np

from .core import codec
from .core.records import ReadBatch, StringColumn

HEADLINE_ADAPTER = b"CTGTAGGCACCATCAAT"
SMALL_RNA_ADAPTER = b"TGGAATTCTCGGGTGCCAAGG"


def _render(bases, quals, lengths) -> bytes:
    n = len(lengths)
    batch = ReadBatch(
        bases=bases.astype(np.uint8),
        quals=quals.astype(np.int8),
        lengths=lengths.astype(np.int32),
        counts=np.ones(n, np.int32),
        names=StringColumn.from_list([b"r%d" % i for i in range(n)]),
        names2=StringColumn.from_list([b""] * n),
        is_fastq=True,
        qual_ascii=np.ones(n, bool),
    )
    return codec.render(batch, out_fastq=True, ascii_qual=True, q_offset=33)


def _headline_quals(rng, n, read_len):
    """The headline lane's quality model: Phred around 36, falling 12
    along the read, clipped to [2, 40]."""
    cols = np.arange(read_len)
    quals = np.clip(rng.normal(36, 4, (n, read_len))
                    - (cols[None, :] / read_len) * 12, 2, 40)
    return (quals + 33).astype(np.uint8).astype(np.int16) - 33


def synth_lane_bytes(n, read_len, seed=42, adapter=HEADLINE_ADAPTER) -> bytes:
    """``n`` FASTQ reads of ``read_len`` random ACGT bases, 30 % of them
    with ``adapter`` spiked in from a position in ``[30, read_len - 5)``,
    qualities falling along the read (Phred+33)."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n, read_len))
    has_ad = rng.random(n) < 0.3
    pos = rng.integers(30, read_len - 5, n)
    for j, ch in enumerate(adapter):
        m = has_ad & (pos + j < read_len)
        bases[m, (pos + j)[m]] = ch
    return _render(bases, _headline_quals(rng, n, read_len),
                   np.full(n, read_len, np.int32))


def synth_small_rna_lane_bytes(n, read_len=50, adapter=SMALL_RNA_ADAPTER,
                               seed=7) -> bytes:
    """A small-RNA lane: each read is an insert of 15-35 random bases,
    then ``adapter`` with a base miscalled at 2 % per position, then a
    random tail, cut to ``read_len``.  About 2 % of the reads are
    adapter-only (insert 0), 5 % carry Ns, 10 % are trimmed to a random
    length in ``[10, read_len]``; qualities are Phred+33 around 32."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bases = rng.choice(acgt, size=(n, read_len))
    ins = rng.integers(15, 36, n)
    ins[rng.random(n) < 0.02] = 0
    ad = np.frombuffer(adapter, np.uint8)
    for j, ch in enumerate(ad):
        col = ins + j
        m = col < read_len
        rows = np.nonzero(m)[0]
        miscall = rng.random(len(rows)) < 0.02
        bases[rows, col[m]] = np.where(miscall,
                                       rng.choice(acgt, len(rows)), ch)
    n_rows = rng.random(n) < 0.05
    n_mask = n_rows[:, None] & (rng.random((n, read_len)) < 0.04)
    bases[n_mask] = ord("N")
    lengths = np.full(n, read_len, np.int32)
    short = rng.random(n) < 0.10
    lengths[short] = rng.integers(10, read_len + 1, int(short.sum()))
    quals = np.clip(rng.normal(32, 6, (n, read_len)), 2, 40).astype(np.int16)
    return _render(bases, quals, lengths)


def synth_collapse_lane_bytes(n, pool=50_000, seed=11) -> bytes:
    """A clipped small-RNA lane with real duplication: ``n`` FASTQ reads,
    each an insert of 18-30 random ACGT bases drawn from a pool of
    ``pool`` distinct sequences with frequency proportional to 1/rank (a
    few sequences take most reads, as in miRNA-seq); qualities Phred+33
    around 32."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = np.zeros((pool, 30), np.uint8)
    plens = rng.integers(18, 31, pool).astype(np.int32)
    redo = np.arange(pool)
    while len(redo):  # redraw any sequence equal to an earlier one
        seqs[redo] = rng.choice(acgt, size=(len(redo), 30))
        cols = np.arange(30)[None, :]
        seqs[cols >= plens[:, None]] = 0
        _, first = np.unique(seqs, axis=0, return_index=True)
        redo = np.setdiff1d(np.arange(pool), first)
    p = 1.0 / np.arange(1, pool + 1)
    pick = rng.choice(pool, size=n, p=p / p.sum())
    quals = np.clip(rng.normal(32, 6, (n, 30)), 2, 40).astype(np.int16)
    return _render(seqs[pick], quals, plens[pick])


def _barcode_set():
    """24 distinct barcodes of 6 ACGT bases at pairwise Hamming distance
    >= 3, drawn in a seeded order (uint8 ``[24, 6]``)."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    picked = rng.choice(acgt, (1, 6))
    while len(picked) < 24:
        cand = rng.choice(acgt, 6)
        if int((picked != cand[None, :]).sum(axis=1).min()) >= 3:
            picked = np.vstack([picked, cand[None, :]])
    return picked


def synth_barcode_lane_bytes(n, read_len, *, bol=True, seed=13):
    """A multiplexed lane with inline barcodes, and its barcode file:
    ``(lane_bytes, barcode_file_bytes)``.

    ``n`` FASTQ reads of ``read_len`` random ACGT bases with the headline
    lane's qualities; 95 % of them carry one of 24 six-base barcodes
    (:func:`_barcode_set`, pairwise Hamming distance >= 3), drawn
    uniformly, on the 5' end (``bol``) or the 3' end, with one base
    substituted in about 10 % of the barcoded reads and two in about 2 %;
    the other 5 % carry none.  The file names them ``BC01``..``BC24``, one
    ``ident<TAB>barcode`` line each after a comment line."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bcs = _barcode_set()
    k, blen = bcs.shape
    bases = rng.choice(acgt, size=(n, read_len))
    pick = rng.integers(0, k, n)
    tags = bcs[pick]
    u = rng.random(n)
    n_sub = np.where(u < 0.02, 2, np.where(u < 0.12, 1, 0))
    pos = rng.integers(0, blen, n)
    pos2 = (pos + rng.integers(1, blen, n)) % blen  # a second position
    for p, rows in ((pos, n_sub >= 1), (pos2, n_sub == 2)):
        r = np.flatnonzero(rows)
        # a different base: the code plus 1-3, mod 4
        code = np.searchsorted(acgt, tags[r, p[r]])
        tags[r, p[r]] = acgt[(code + rng.integers(1, 4, len(r))) % 4]
    barcoded = rng.random(n) >= 0.05
    cols = slice(0, blen) if bol else slice(read_len - blen, read_len)
    bases[barcoded, cols] = tags[barcoded]
    lane = _render(bases, _headline_quals(rng, n, read_len),
                   np.full(n, read_len, np.int32))
    bcfile = b"#ident\tbarcode\n" + b"".join(
        b"BC%02d\t%s\n" % (i + 1, bcs[i].tobytes()) for i in range(k))
    return lane, bcfile

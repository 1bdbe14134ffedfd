"""Per-read tool transforms as masked torch functions on a padded batch.

Counterpart of ``fastx_toolkit_tpu/ops/transforms.py``: each of the
reference tools' per-record C loops becomes one masked transform over
``bases`` uint8 ``[B, L]`` / ``quals`` int8 ``[B, L]`` / ``lengths``
int32 ``[B]`` on the batch's device, with the same conventions:

* ``bases`` hold raw ASCII bytes, 0 beyond ``lengths`` (PAD);
* every transform returns new tensors plus a ``keep`` bool mask where it
  discards;
* padding is re-zeroed after a transform so downstream ops can rely on
  it.

:func:`barcode_match` is ``fastx_barcode_splitter``'s matcher: a
``[B, K, Lb]`` compare of each read's fragment with every barcode.
"""

from __future__ import annotations

import torch

from ..core.records import BaseCode

_N = ord("N")
_COMPLEMENT = torch.tensor(list(BaseCode.COMPLEMENT), dtype=torch.uint8)


def _iota(bases):
    return torch.arange(bases.shape[1], dtype=torch.int32,
                        device=bases.device)[None, :]


def _in_len(bases, lengths):
    return _iota(bases) < lengths[:, None]


def _zero_pad(bases, quals, lengths):
    m = _in_len(bases, lengths)
    return (torch.where(m, bases, 0).to(torch.uint8),
            torch.where(m, quals, 0).to(quals.dtype))


def contains_n(bases, lengths):
    """True per read iff an 'N' occurs within the read (strchr, e.g.
    fastq_to_fasta.c:81-82)."""
    return ((bases == _N) & _in_len(bases, lengths)).any(dim=1)


def fastq_to_fasta_keep(bases, lengths, *, discard_n: bool):
    """fastq_to_fasta (fastq_to_fasta.c:69-103)."""
    if discard_n:
        return ~contains_n(bases, lengths)
    return torch.ones(bases.shape[0], dtype=torch.bool, device=bases.device)


def trimmer(bases, quals, lengths, *, first: int = 1, last: int = 0,
            trim_end: int = 0, min_len: int = 0):
    """fastx_trimmer (fastx_trimmer.c:105-148): positional trim (-f/-l)
    or end trim (-t/-m), exact C semantics:

    * ``last`` truncates to that base (1-based);
    * ``first`` drops the first ``first-1`` bases, shifting quality too
      (the batch width shrinks by as much); reads shorter than ``first``
      are dropped;
    * ``trim_end`` drops that many 3' bases; empty results and results
      shorter than ``min_len`` are dropped."""
    keep = torch.ones(bases.shape[0], dtype=torch.bool, device=bases.device)
    if last != 0:
        lengths = lengths.clamp(max=last)
    if first != 1:
        keep &= lengths >= first
        bases = bases[:, first - 1:]
        quals = quals[:, first - 1:]
        lengths = lengths - (first - 1)
    if trim_end > 0:
        keep &= lengths > trim_end
        lengths = lengths - trim_end
        keep &= lengths >= min_len
    lengths = lengths.clamp(min=0)
    bases, quals = _zero_pad(bases, quals, lengths)
    return bases, quals, lengths, keep


def quality_filter_keep(quals, lengths, *, min_quality: int,
                        min_percent: int):
    """fastq_quality_filter (fastq_quality_filter.c:78-129): keep iff the
    (len*(100-p)/100)-th smallest quality >= q, i.e. iff |{quality < q}|
    <= len*(100-p)/100."""
    below = (_in_len(quals, lengths) & (quals < min_quality)).sum(
        dim=1, dtype=torch.int32)
    n = (lengths * (100 - min_percent)) // 100
    return below <= n


def quality_trimmer(bases, quals, lengths, *, threshold: int, min_len: int):
    """fastq_quality_trimmer (fastq_quality_trimmer.c:91-102): truncate
    the 3' run of bases with quality < threshold; keep iff the result is
    non-empty and >= min_len."""
    passing = _in_len(bases, lengths) & (quals >= threshold)
    pos1 = torch.where(passing, _iota(bases) + 1, 0)
    if pos1.shape[1]:
        new_len = pos1.max(dim=1).values.to(torch.int32)
    else:
        new_len = torch.zeros(bases.shape[0], dtype=torch.int32,
                              device=bases.device)
    keep = (new_len > 0) & (new_len >= min_len)
    bases, quals = _zero_pad(bases, quals, new_len)
    return bases, quals, new_len, keep


def masker(bases, quals, lengths, *, threshold: int, mask_char: int):
    """fastq_masker (fastq_masker.c:92-108): replace bases with quality <
    threshold by mask_char; returns (bases, masked_per_read_bool,
    masked_nucleotide_count_per_read)."""
    m = _in_len(bases, lengths) & (quals < threshold)
    bases = torch.where(m, torch.tensor(mask_char, dtype=torch.uint8,
                                        device=bases.device), bases)
    return bases, m.any(dim=1), m.sum(dim=1, dtype=torch.int32)


def artifacts_keep(bases, lengths):
    """fastx_artifacts_filter (fastx_artifacts_filter.c:56-112): discard
    iff any single base letter covers all but <= 3 positions."""
    m = _in_len(bases, lengths)
    worst = torch.zeros(bases.shape[0], dtype=torch.int32,
                        device=bases.device)
    for ch in b"ACGT":
        worst = torch.maximum(worst, ((bases == ch) & m).sum(
            dim=1, dtype=torch.int32))
    return ~(worst >= (lengths - 3))


def reverse_complement(bases, quals, lengths, *, is_fastq: bool):
    """fastx_reverse_complement (fastx_reverse_complement.c:74-104)."""
    comp = _COMPLEMENT.to(bases.device)[bases.long()]
    io = _iota(bases)
    idx = torch.where(_in_len(bases, lengths), lengths[:, None] - 1 - io,
                      io).long()
    rb = torch.gather(comp, 1, idx)
    rq = torch.gather(quals, 1, idx) if is_fastq else quals
    return _zero_pad(rb, rq, lengths)


def nucleotide_changer(bases, lengths, *, rna_mode: bool):
    """fasta_nucleotide_changer (fasta_nucleotide_changer.c:101-113): -r
    T->U (DNA-to-RNA); -d U->T.  Returns (bases, changes_per_read,
    first_forbidden_pos per read or L if none)."""
    src, dst = (ord("T"), ord("U")) if rna_mode else (ord("U"), ord("T"))
    m = _in_len(bases, lengths)
    forbidden = m & (bases == dst)
    L = bases.shape[1]
    first_bad = torch.where(forbidden.any(dim=1),
                            forbidden.to(torch.uint8).argmax(dim=1), L)
    hit = m & (bases == src)
    bases = torch.where(hit, torch.tensor(dst, dtype=torch.uint8,
                                          device=bases.device), bases)
    return bases, hit.sum(dim=1, dtype=torch.int32), first_bad.to(torch.int32)


# rows a barcode_match pass compares at once: the [rows, K, Lb] compare
# stays near 0.2 GB at 96 barcodes of 8 bases
MATCH_ROWS = 262_144


def barcode_match(bases, lengths, barcodes, barcode_lens, penalties, *,
                  bol: bool, barcodes_length: int):
    """fastx_barcode_splitter's matching (fastx_barcode_splitter.pl:208-276).

    ``barcodes`` uint8 ``[K, barcodes_length]`` (zero-padded; partial
    variants already expanded, in file order), ``barcode_lens`` int32
    ``[K]``, ``penalties`` int32 ``[K]`` = barcodes_length - len(barcode).

    The fragment is the barcode-length prefix (bol) or suffix (eol) of the
    read; a read shorter than that gives a shorter fragment whose missing
    positions never match.  Mismatches = fragment length - positional
    matches with the (possibly shorter) barcode, + penalty.  The Perl scans
    the barcodes in file order keeping strict improvements over a start of
    ``barcodes_length``, so the winner is the first barcode of the least
    count, and only if it beats the start.

    Returns ``(best_index int32 [B], best_mm int32 [B])``; ``best_index``
    is -1 (and ``best_mm`` the start) where no barcode beat the start, as
    for every read when ``K`` is 0.  Requires ``L >= barcodes_length`` for
    ``bol`` (the caller pads).  Rows are compared ``MATCH_ROWS`` at a time.
    """
    B = bases.shape[0]
    K = barcodes.shape[0]
    dev = bases.device
    if K == 0:
        return (torch.full((B,), -1, dtype=torch.int32, device=dev),
                torch.full((B,), barcodes_length, dtype=torch.int32,
                           device=dev))
    bc_valid = (torch.arange(barcodes_length, device=dev)[None, :]
                < barcode_lens[:, None])
    penalties = penalties.to(torch.int64)
    idx, mm = [], []
    for r0 in range(0, max(B, 1), MATCH_ROWS):
        i, m = _match_rows(bases[r0:r0 + MATCH_ROWS],
                           lengths[r0:r0 + MATCH_ROWS], barcodes, bc_valid,
                           penalties, bol=bol,
                           barcodes_length=barcodes_length)
        idx.append(i)
        mm.append(m)
    return torch.cat(idx), torch.cat(mm)


def _match_rows(bases, lengths, barcodes, bc_valid, penalties, *, bol,
                barcodes_length):
    L = bases.shape[1]
    K = barcodes.shape[0]
    lengths = lengths.to(torch.int64)
    cols = torch.arange(barcodes_length, device=bases.device)[None, :]
    if bol:
        frag = bases[:, :barcodes_length]
    else:
        start = (lengths - barcodes_length).clamp(min=0)
        idx = (start[:, None] + cols).clamp(max=max(L - 1, 0))
        frag = torch.gather(bases, 1, idx)
    frag_len = lengths.clamp(max=barcodes_length)
    frag_valid = cols < frag_len[:, None]
    frag = torch.where(frag_valid, frag, 0)
    eq = ((frag[:, None, :] == barcodes[None, :, :]) & bc_valid[None, :, :]
          & frag_valid[:, None, :])
    matches = eq.sum(dim=2, dtype=torch.int32)
    mm = frag_len[:, None] - matches + penalties[None, :]
    # the first barcode of the least count: the least of mm * K + k, so
    # no tie is left to argmin's rule
    key = (mm * K + torch.arange(K, device=bases.device)[None, :]).amin(dim=1)
    best_mm = key.div(K, rounding_mode="floor")
    matched = best_mm < barcodes_length
    return (torch.where(matched, key - best_mm * K, -1).to(torch.int32),
            torch.where(matched, best_mm, barcodes_length).to(torch.int32))

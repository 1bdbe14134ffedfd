"""Per-read tool transforms as masked torch functions on a padded batch.

Counterpart of ``fastx_toolkit_tpu/ops/transforms.py:27-185``: each of the
reference tools' per-record C loops becomes one masked transform over
``bases`` uint8 ``[B, L]`` / ``quals`` int8 ``[B, L]`` / ``lengths``
int32 ``[B]`` on the batch's device, with the same conventions:

* ``bases`` hold raw ASCII bytes, 0 beyond ``lengths`` (PAD);
* every transform returns new tensors plus a ``keep`` bool mask where it
  discards;
* padding is re-zeroed after a transform so downstream ops can rely on
  it.

(``barcode_match`` belongs to the barcodes slice.)
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

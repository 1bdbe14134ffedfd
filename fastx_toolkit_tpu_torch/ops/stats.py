"""fastx_quality_stats as a device-side histogram reduction.

Counterpart of ``fastx_toolkit_tpu/ops/stats.py``, every public name
kept.  FASTX-Toolkit accumulates, per cycle (position) and per
nucleotide slot (ALL/A/C/G/T/N), a counting-sort histogram over quality
values plus count/min/max/sum (fastx_quality_stats.c:94-216).  Here one
batch's accumulation is a scatter-add producing

* ``count [L, 6]``      — weighted by collapsed reads_count
* ``hist  [L, 6, 109]`` — weighted by reads_count (FASTQ only)
* ``qsum  [L, 6]``      — UNweighted sum of quality values; the reference
  adds ``quality_value`` once per *sequence* even for collapsed reads
  (fastx_quality_stats.c:200,206), a quirk reproduced exactly
* ``qmin/qmax [L, 6]``  — also unweighted, init 100/-100

and :class:`StatsAccumulator` merges the partials on the host in int64.
Quantiles come from the merged histogram with the reference's cumulative
walk (get_nth_value, fastx_quality_stats.c:218-247).

Two engines give identical accumulators (:func:`stats_path`):

* ``device`` — :func:`accumulate_dispatch`: for FASTQ the histogram
  kernel K5 (``kernels/stats_cuda.py``, ``csrc/stats_hist.cu``) and
  :func:`derive_from_hist`; for FASTA the plain scatter
  :func:`accumulate` (``index_add_``/``scatter_reduce_``), which the
  reference too computes outside its Pallas kernel;
* ``host`` — the native codec's histogram (:func:`host_accumulate`, and
  the CLI's raw-line ``native.stats_lines_q``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.records import BaseCode

NUC_NAMES = ("ALL", "A", "C", "G", "T", "N")
NSLOTS = 6
NBINS = 109  # quality values -15..93 inclusive
MIN_Q = -15

_STATS_LUT = np.asarray(BaseCode.STATS_INDEX)


def _host(a) -> np.ndarray:
    """A partial (tensor on any device, or array) as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class StatsAccumulator:
    """Host-side running totals over batches (numpy, merged with +/min/max)."""

    count: np.ndarray  # [L, 6] int64
    hist: np.ndarray  # [L, 6, 109] int64
    qsum: np.ndarray  # [L, 6] int64
    qmin: np.ndarray  # [L, 6] int32
    qmax: np.ndarray  # [L, 6] int32

    @classmethod
    def empty(cls, L: int) -> "StatsAccumulator":
        return cls(
            count=np.zeros((L, NSLOTS), np.int64),
            hist=np.zeros((L, NSLOTS, NBINS), np.int64),
            qsum=np.zeros((L, NSLOTS), np.int64),
            qmin=np.full((L, NSLOTS), 100, np.int32),
            qmax=np.full((L, NSLOTS), -100, np.int32),
        )

    def merge_partial(self, count, hist, qsum, qmin, qmax) -> None:
        """Merge one batch's partials (numpy arrays or tensors on any
        device); the accumulator grows to a longer batch's L."""
        count, hist, qsum, qmin, qmax = (
            _host(a) for a in (count, hist, qsum, qmin, qmax))
        L = count.shape[0]
        if L > self.count.shape[0]:
            grown = StatsAccumulator.empty(L)
            grown.merge_partial(self.count, self.hist, self.qsum, self.qmin, self.qmax)
            self.__dict__.update(grown.__dict__)
        self.count[:L] += count
        self.hist[:L] += hist
        self.qsum[:L] += qsum
        np.minimum(self.qmin[:L], qmin, out=self.qmin[:L])
        np.maximum(self.qmax[:L], qmax, out=self.qmax[:L])

    def num_cycles(self) -> int:
        nz = np.flatnonzero(self.count[:, 0] == 0)
        return int(nz[0]) if len(nz) else self.count.shape[0]


def accumulate(bases, quals, lengths, counts, *, is_fastq: bool):
    """One batch -> partial ``(count, hist, qsum, qmin, qmax)`` int32
    tensors on the batch's device: the plain scatter reduction
    (``index_add_``, and ``scatter_reduce_`` with amin/amax)."""
    B, L = bases.shape
    dev = bases.device
    i32 = torch.int32
    col = torch.arange(L, dtype=i32, device=dev)[None, :]
    valid = col < lengths.to(i32)[:, None]
    nuc = torch.from_numpy(_STATS_LUT).to(dev)[bases.long()].to(i32)
    w = torch.where(valid, counts.to(i32)[:, None], 0).to(i32).reshape(-1)

    slot_all = (col * NSLOTS).expand(B, L)  # nuc slot 0
    slot_nuc = slot_all + nuc
    idx_all = slot_all.reshape(-1).long()
    idx_nuc = slot_nuc.reshape(-1).long()

    def add(size, idx_a, idx_n, vals):
        out = torch.zeros(size, dtype=i32, device=dev)
        return out.index_add_(0, idx_a, vals).index_add_(0, idx_n, vals)

    count = add(L * NSLOTS, idx_all, idx_nuc, w)
    if not is_fastq:
        return (
            count.reshape(L, NSLOTS),
            torch.zeros((L, NSLOTS, NBINS), dtype=i32, device=dev),
            torch.zeros((L, NSLOTS), dtype=i32, device=dev),
            torch.full((L, NSLOTS), 100, dtype=i32, device=dev),
            torch.full((L, NSLOTS), -100, dtype=i32, device=dev),
        )

    q = quals.to(i32)
    qbin = (q - MIN_Q).clamp(0, NBINS - 1)
    hist = add(L * NSLOTS * NBINS, (slot_all * NBINS + qbin).reshape(-1).long(),
               (slot_nuc * NBINS + qbin).reshape(-1).long(), w)

    # sum/min/max are UNweighted (once per sequence)
    w1 = torch.where(valid, q, 0).reshape(-1)
    qsum = add(L * NSLOTS, idx_all, idx_nuc, w1)

    def reduce(init, vals, how):
        out = torch.full((L * NSLOTS,), init, dtype=i32, device=dev)
        out.scatter_reduce_(0, idx_all, vals, how)
        return out.scatter_reduce_(0, idx_nuc, vals, how)

    qmin = reduce(100, torch.where(valid, q, 1000).reshape(-1), "amin")
    qmax = reduce(-100, torch.where(valid, q, -1000).reshape(-1), "amax")
    # the reduction includes the 100/-100 initial values, so the sentinels
    # of masked positions never win; the clamp mirrors the reference's
    qmin = qmin.clamp(max=100)
    qmax = qmax.clamp(min=-100)

    return (
        count.reshape(L, NSLOTS),
        hist.reshape(L, NSLOTS, NBINS),
        qsum.reshape(L, NSLOTS),
        qmin.reshape(L, NSLOTS),
        qmax.reshape(L, NSLOTS),
    )


# ---------------------------------------------------------------------------
# host-side report generation (exact integer semantics)
# ---------------------------------------------------------------------------

# The reference's histogram is bases_values_count[QUALITY_VALUES_RANGE]
# == int[108] (quality 93 would index one past the end); the walk
# (fastx_quality_stats.c:237-245) has NO bounds check, so on FASTA input
# (empty histograms, count > 0) it marches through the adjacent struct
# fields.  That memory is fully determined by the accumulator state plus
# the struct layout: fastx.h's `#pragma pack(1)` (fastx.h:61) is never
# popped and leaks into every file that includes it, so nucleotide_data
# is PACKED -- int min; int max; int count; unsigned long long sum;
# int bases_values_count[108]; -> 113 int32 slots, hist at int-offset 5 --
# 6 structs per cycle, 25000 cycles zero/100/-100-initialized
# (init_values, fastx_quality_stats.c:139-164).  _OOBView serves that
# int32 view so the emergent quantiles are reproduced exactly
# (verified differentially against the compiled reference).
_C_HIST_LEN = 108
_STRUCT_INTS = 113
_C_MAX_CYCLES = 25000


class _OOBView:
    """int32 view of the reference's cycles[] memory starting at one
    struct's bases_values_count[0]."""

    def __init__(self, acc: "StatsAccumulator", cyc: int, nuc: int):
        self.acc = acc
        self.base = (cyc * NSLOTS + nuc) * _STRUCT_INTS + 5
        self.limit = _C_MAX_CYCLES * NSLOTS * _STRUCT_INTS - self.base

    def __getitem__(self, pos: int) -> int:
        g = self.base + pos
        struct_idx, off = divmod(g, _STRUCT_INTS)
        cyc, nuc = divmod(struct_idx, NSLOTS)
        acc = self.acc
        in_acc = cyc < acc.count.shape[0]
        if off == 0:
            return int(acc.qmin[cyc, nuc]) if in_acc else 100
        if off == 1:
            return int(acc.qmax[cyc, nuc]) if in_acc else -100
        def as_i32(v):
            v &= 0xFFFFFFFF
            return v - 0x100000000 if v >= 0x80000000 else v

        if off == 2:
            return as_i32(int(acc.count[cyc, nuc])) if in_acc else 0
        if off == 3:
            return as_i32(int(acc.qsum[cyc, nuc])) if in_acc else 0
        if off == 4:
            return as_i32(int(acc.qsum[cyc, nuc]) >> 32) if in_acc else 0
        h = off - 5
        if not in_acc or h >= NBINS:
            return 0
        return int(acc.hist[cyc, nuc, h])


def _get_nth_value(acc: "StatsAccumulator", cyc: int, nuc: int, n: int) -> int:
    """The reference's counting-sort walk (fastx_quality_stats.c:218-247),
    including its out-of-bounds continuation for empty histograms."""
    if n == 0:
        return int(acc.qmin[cyc, nuc])
    arr = _OOBView(acc, cyc, nuc)
    pos = 0
    guard = arr.limit
    while n > 0 and pos < guard:
        v = arr[pos]
        if v > n:
            break
        n -= v
        pos += 1
        while pos < guard and arr[pos] == 0:
            pos += 1
    return pos + MIN_Q


def _fmt_mean(qsum: int, count: int) -> str:
    """%3.2f of sum/count; the reference hits 0.0/0.0 -> '-nan' for empty
    per-nucleotide slots (x86 SSE negative qNaN).

    The reference's ``sum`` field is ``unsigned long long``
    (fastx_quality_stats.c:120): a NEGATIVE per-slot total (possible,
    qualities go down to -15) wraps mod 2^64.  The ``%lld`` sum column
    reinterprets it back to the signed value, but the mean is computed
    from the UNSIGNED value — ``(double)sum/(double)count``
    (:305,:392) — so e.g. sum=-5, count=1 prints mean
    18446744073709551616.00.  Deterministic, so reproduced here."""
    if count == 0:
        return "-nan"
    if qsum < 0:
        qsum += 1 << 64  # the reference's unsigned wraparound
    return "%3.2f" % (float(qsum) / float(count))


def _slot_numbers(acc: StatsAccumulator, cyc: int, nuc: int):
    count = int(acc.count[cyc, nuc])
    qmin = int(acc.qmin[cyc, nuc])
    qmax = int(acc.qmax[cyc, nuc])
    qsum = int(acc.qsum[cyc, nuc])
    q1 = _get_nth_value(acc, cyc, nuc, count // 4)
    med = _get_nth_value(acc, cyc, nuc, count // 2)
    q3 = _get_nth_value(acc, cyc, nuc, count * 3 // 4)
    iqr = q3 - q1
    # C's IQR*3/2 truncates toward zero (matters only if IQR < 0)
    half3 = int(iqr * 3 / 2) if iqr < 0 else iqr * 3 // 2
    lw = qmin if (q1 - half3) < qmin else (q1 - half3)
    rw = qmax if (q3 + half3) > qmax else (q3 + half3)
    return count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw


def render_old_format(acc: StatsAccumulator) -> str:
    """print_old_statistics (fastx_quality_stats.c:349-417)."""
    out = [
        "column\tcount\tmin\tmax\tsum\tmean\tQ1\tmed\tQ3\tIQR\tlW\trW\t"
        "A_Count\tC_Count\tG_Count\tT_Count\tN_Count\tMax_count\n"
    ]
    ncyc = acc.num_cycles()
    max_count = int(acc.count[0, 0]) if ncyc else 0
    for i in range(ncyc):
        count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw = _slot_numbers(acc, i, 0)
        out.append(
            "%d\t%d\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\n"
            % (
                i + 1, count, qmin, qmax, qsum, _fmt_mean(qsum, count),
                q1, med, q3, iqr, lw, rw,
                int(acc.count[i, 1]), int(acc.count[i, 2]), int(acc.count[i, 3]),
                int(acc.count[i, 4]), int(acc.count[i, 5]), max_count,
            )
        )
    return "".join(out)


def render_new_format(acc: StatsAccumulator) -> str:
    """print_statistics, the -N format (fastx_quality_stats.c:316-344)."""
    hdr = ["cycle\tmax_count"]
    stat_names = ("count", "min", "max", "sum", "mean", "Q1", "med", "Q3", "IQR", "lW", "rW")
    for nuc in NUC_NAMES:
        for s in stat_names:
            hdr.append("\t%s_%s" % (nuc, s))
    out = ["".join(hdr) + "\n"]
    ncyc = acc.num_cycles()
    max_count = int(acc.count[0, 0]) if ncyc else 0
    for i in range(ncyc):
        row = ["%d\t%d" % (i + 1, max_count)]
        for nuc in range(NSLOTS):
            count, qmin, qmax, qsum, q1, med, q3, iqr, lw, rw = _slot_numbers(acc, i, nuc)
            row.append(
                "\t%d\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\t%d"
                % (count, qmin, qmax, qsum, _fmt_mean(qsum, count),
                   q1, med, q3, iqr, lw, rw)
            )
        out.append("".join(row) + "\n")
    return "".join(out)


def derive_from_hist(pernuc_hist):
    """FASTQ statistics from the per-(pos, nuc, qval) histogram alone.

    get_reads_count is always 1 for FASTQ (fastx.c:479-481), so the
    weighted and unweighted accumulators coincide and count/qsum/min/max
    are exact functions of the histogram.  Slot 0 of the input counts
    unknown bytes (STATS_INDEX==0); the reference adds every base to ALL
    *and* to its nuc slot, so ALL = sum over slots + the slot-0 adds.
    Takes a numpy array or a tensor on any device (K5's int32 output is
    widened to int64 here).  Returns (count, hist, qsum, qmin, qmax)
    matching accumulate()'s layout, as numpy arrays.
    """
    pernuc_hist = _host(pernuc_hist).astype(np.int64)
    hist = pernuc_hist.copy()
    hist[:, 0] = pernuc_hist.sum(axis=1) + pernuc_hist[:, 0]
    count = hist.sum(axis=2)
    vals = np.arange(MIN_Q, MIN_Q + NBINS, dtype=np.int64)
    qsum = (hist * vals[None, None, :]).sum(axis=2)
    nz = hist > 0
    any_nz = nz.any(axis=2)
    qmin = np.where(any_nz, vals[np.argmax(nz, axis=2)], 100).astype(np.int32)
    qmax = np.where(
        any_nz, vals[NBINS - 1 - np.argmax(nz[:, :, ::-1], axis=2)], -100
    ).astype(np.int32)
    return count, hist, qsum, qmin, qmax


def host_accumulate(bases, quals, lengths, counts, *, is_fastq: bool):
    """Host-native (C++) accumulation — identical results to accumulate().

    One int64 increment per base into the per-(cycle, nucleotide, quality)
    histogram (native/fastx_codec.cpp fx_stats_hist_q); everything else
    (ALL slot, count, sum, min, max) derives from it because FASTQ
    multiplicity is always 1 (fastx.c:479-481).  FASTA accumulates the
    weighted per-nucleotide counts only (the reference skips the quality
    block for FASTA, fastx_quality_stats.c:194)."""
    from ..core import native

    bases = np.ascontiguousarray(bases, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if is_fastq:
        pernuc = native.stats_hist_q(
            bases, np.ascontiguousarray(quals, np.int8), lengths
        )
        return derive_from_hist(pernuc)
    pn = native.stats_counts(
        bases, lengths, np.ascontiguousarray(counts, np.int32)
    )
    L = pn.shape[0]
    count = pn.copy()
    count[:, 0] = pn.sum(axis=1) + pn[:, 0]
    return (
        count,
        np.zeros((L, NSLOTS, NBINS), np.int64),
        np.zeros((L, NSLOTS), np.int64),
        np.full((L, NSLOTS), 100, np.int32),
        np.full((L, NSLOTS), -100, np.int32),
    )


def stats_path() -> str:
    """'host' or 'device' accumulation for the stats CLI.

    FASTX_STATS_PATH=host|device overrides the shared policy
    (``engine.policy``: the host C++ histogram when the native codec is
    there, on a card too).  Both paths produce
    bit-identical accumulators.
    """
    from ..engine import policy

    return policy.resolve("stats", os.environ.get("FASTX_STATS_PATH"))


def accumulate_dispatch(bases, quals, lengths, counts, *, is_fastq: bool):
    """One batch of tensors -> partials: for FASTQ the histogram kernel K5
    (its plain version on CPU tensors) and :func:`derive_from_hist`, as the
    reference does on its chip; for FASTA :func:`accumulate`.  Results are
    identical either way."""
    if is_fastq:
        from ..kernels.stats_cuda import stats_hist

        return derive_from_hist(stats_hist(bases, quals, lengths))
    return accumulate(bases, quals, lengths, counts, is_fastq=False)


def counts_only(bases, lengths, counts):
    """Per-cycle nucleotide counts ``[L, 6]`` int32 without the quality
    histogram, for the fused pipeline's stats stage where only counts are
    consumed.  The reference takes six masked float32 einsums; here the
    sums are exact integer sums, equal to those wherever a float32 sum is
    exact (totals below 2^24)."""
    B, L = bases.shape
    dev = bases.device
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    nuc = torch.from_numpy(_STATS_LUT).to(dev)[bases.long()]
    w = torch.where(valid, counts.to(torch.int64)[:, None], 0)
    cols = [w.sum(dim=0)]
    for s in range(1, NSLOTS):
        cols.append(torch.where(nuc == s, w, 0).sum(dim=0))
    # the reference adds every base to ALL and to its slot; unknown bytes
    # have slot 0 == ALL, so ALL gets them twice
    cols[0] = cols[0] + torch.where(nuc == 0, w, 0).sum(dim=0)
    return torch.stack(cols, dim=1).to(torch.int32)

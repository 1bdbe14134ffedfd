"""The fused preprocessing chain: configuration, batch plumbing and its
decisions bodies.

Counterpart of ``fastx_toolkit_tpu/engine/pipeline.py``: ``PipelineConfig``
(same fields and defaults), ``padded_width``/``to_device``, the host
packers (``pack_batch``, ``pack_batch2``, ``scan_alphabet``) and three
bodies that give identical decisions:

* :func:`pipeline_body` — the unpacked chain over ``[B, L]`` bytes and
  qualities (the transforms of ``ops/transforms.py`` and
  ``ops/clipper.clip_batch``, whose DP is K4, ``csrc/align_unpacked.cu``);
* :func:`packed_pipeline_body` — the same after unpacking the 2-bit or
  4-bit upload on the device;
* :func:`packed_fast_body` — the fully-packed body, which never builds an
  unpacked ``[B, L]`` representation:

  * quality filter  — popcount over the ``qual < q`` plane bytes;
  * quality trimmer — the last passing position by lowest-set-bit tricks;
  * masker          — one OR of its plane into the effective-N plane;
  * clipper DP      — ``csrc/align_packed.cu`` at K1's or K3's shapes,
    on the 2-bit words and the N|mask plane;
  * artifacts / N   — K2 (``csrc/packed_counts.cu``).

:func:`packed_decisions_pipeline` routes a packed chunk as the reference
does: the fast body inside the packed kernels' gate (an ACGTN adapter of
H_pad <= 72 within the field bounds), else the unpacking body and K4.
With ``cfg.with_stats`` the unpacked and the unpacking bodies also take
the reads' ``counts`` column and append the per-cycle nucleotide counts
of the kept reads (``ops/stats.counts_only``, ``[L, 6]`` int32) to what
they return, as the reference's bodies do; :func:`fused_pipeline` is the
reference's single-device step over ``(bases, quals, lengths, counts)``,
and ``parallel/mesh.py`` sums the counts over a process group.  Every
body runs on the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import native
from ..kernels.align_cuda import adapter_codes, align_batch_packed, packed_ok
from ..kernels.counts_cuda import packed_counts
from ..ops import stats as stats_ops
from ..ops import transforms
from ..ops.clipper import (
    adapter_cutoff_index,
    clip_batch,
    clip_cut_lengths,
    clip_write_mask,
)

def padded_width(l: int) -> int:  # noqa: E741
    """The reference's padded batch width: L to a multiple of 32 (>= 32).
    The width matters beyond the reads: ``trimmer -f`` slices it and the
    nucleotide changer's abort compares against it, as in the reference.
    (The reference also pads B to a power of two, to keep XLA's compiled
    shapes few; an eager port has no shape to keep, so B stays as read.)"""
    return max(32, -(-l // 32) * 32)


def to_device(batch):
    """ReadBatch -> ``(bases, quals, lengths, counts)``: numpy arrays of
    ``len(batch)`` rows, the width padded to :func:`padded_width` with
    zeros."""
    b, l = batch.bases.shape  # noqa: E741
    ll = padded_width(max(l, 1))
    bases = np.zeros((b, ll), dtype=np.uint8)
    quals = np.zeros((b, ll), dtype=np.int8)
    bases[:, :l] = batch.bases
    quals[:, :l] = batch.quals
    return (bases, quals, np.array(batch.lengths, dtype=np.int32),
            np.array(batch.counts, dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Parameters of the fused chain; the defaults are the headline chain
    ``fastx_trimmer | fastq_quality_filter -q 20 -p 50 |
    fastq_quality_trimmer -t 20 | fastq_masker -q 20 |
    fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | fastx_artifacts_filter``
    (field meanings as in the reference's PipelineConfig)."""

    adapter: bytes = b"CTGTAGGCACCATCAAT"
    trim_last: int = 0
    filter_q: int = 20
    filter_p: int = 50
    trim_q: int = 20
    trim_minlen: int = 0
    mask_q: int = 20
    clip_minlen: int = 5
    with_stats: bool = False
    with_filter: bool = True
    with_qtrim: bool = True
    with_mask: bool = True
    with_clip: bool = True
    with_artifacts: bool = True
    clip_keep_n: bool = True
    to_fasta_discard_n: bool = False


def config_from_reference(cfg) -> PipelineConfig:
    """Carry a reference ``PipelineConfig`` (any object with its
    attributes) across to the port's."""
    return PipelineConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(PipelineConfig)})


def _thresholds(cfg: PipelineConfig) -> tuple[int, ...]:
    """The distinct ``qual < t`` plane thresholds, in upload order."""
    ts = []
    if cfg.with_filter:
        ts.append(cfg.filter_q)
    if cfg.with_qtrim:
        ts.append(cfg.trim_q)
    if cfg.with_mask:
        ts.append(cfg.mask_q)
    return tuple(dict.fromkeys(ts))


def _popcount8(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each byte value (int32 in, int32 out); torch has no
    popcount op."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _valid_bits_mask(l: torch.Tensor, nb: int) -> torch.Tensor:  # noqa: E741
    """``[B]`` lengths -> ``[B, nb]`` int32: the MSB-first valid-bit mask
    of each plane byte (bit k of byte b covers position 8*b + 7 - k)."""
    bi = torch.arange(nb, dtype=torch.int32, device=l.device)[None, :]
    nvalid = (l[:, None] - 8 * bi).clamp(0, 8)
    return (torch.full_like(nvalid, 0xFF00) >> nvalid) & 0xFF


def _words_T(bytes2d: torch.Tensor, need_bytes: int) -> torch.Tensor:
    """``[B, nb]`` uint8 -> ``[need_bytes//4, B]`` int32 (little-endian
    words, zero-padded columns, transposed for the packed kernels)."""
    B, nb = bytes2d.shape
    if nb < need_bytes:
        bytes2d = torch.nn.functional.pad(bytes2d, (0, need_bytes - nb))
    else:
        bytes2d = bytes2d[:, :need_bytes].contiguous()
    return bytes2d.view(torch.int32).T.contiguous()


def packed_fast_ok(cfg: PipelineConfig, Le: int) -> bool:
    """The port's gate for the fully-packed body (which takes the 2-bit
    upload): no stats reduction, and, with the clipper, an ACGTN adapter
    and reads of ``Le`` columns inside K1's or K3's bounds.  Any batch
    size."""
    if cfg.with_stats:
        return False
    if cfg.with_clip:
        return (adapter_codes(cfg.adapter) is not None
                and packed_ok(Le, len(cfg.adapter)))
    return True


def packed_quality_stage(b2, planes, lengths, cfg: PipelineConfig,
                         has_n_plane: bool):
    """The quality stages on the packed planes and the kernels' operands.

    Returns ``(l, keep, b2w, nmw)``: lengths after trimming, the keep mask
    so far, and the words K1/K2 read (``nmw`` is None when the chunk has
    no N source; ``b2w``/``nmw`` are None when no kernel runs)."""
    B, nb4 = b2.shape
    Le = nb4 * 4
    nb8 = planes.shape[2]
    thr = {t: i for i, t in enumerate(_thresholds(cfg))}
    base = 1 if has_n_plane else 0
    l = lengths.to(torch.int32)  # noqa: E741
    keep = torch.ones(B, dtype=torch.bool, device=b2.device)

    if cfg.trim_last != 0:  # fastx_trimmer -l
        l = l.clamp(max=cfg.trim_last)  # noqa: E741
    vmask = _valid_bits_mask(l, nb8)

    if cfg.with_filter:
        pf = planes[:, base + thr[cfg.filter_q]].to(torch.int32) & vmask
        below = _popcount8(pf).sum(dim=1)
        keep &= below <= (l * (100 - cfg.filter_p)) // 100

    if cfg.with_qtrim:
        # last position with qual >= t within l: per byte, the lowest set
        # bit of the masked pass-bits is the highest such position
        pt = planes[:, base + thr[cfg.trim_q]].to(torch.int32)
        v = (~pt) & vmask
        low = v & -v
        tz = _popcount8((low - 1) & 0xFF)  # log2(low) when v != 0
        bi = torch.arange(nb8, dtype=torch.int32, device=b2.device)[None, :]
        cand = torch.where(v > 0, 8 * bi + 8 - tz, 0)
        new_l = cand.max(dim=1).values.to(torch.int32)
        keep &= (new_l > 0) & (new_l >= cfg.trim_minlen)
        l = new_l  # noqa: E741

    # effective-N plane: input Ns OR masked positions (the masker's only
    # decision-path effect); positions beyond the read are 0 by packing
    nmb = None
    if has_n_plane:
        nmb = planes[:, 0]
    if cfg.with_mask:
        pm = planes[:, base + thr[cfg.mask_q]]
        nmb = pm if nmb is None else (nmb | pm)

    b2w = nmw = None
    if cfg.with_clip or _needs_counts(cfg):
        L32 = -(-Le // 32) * 32
        b2w = _words_T(b2, L32 // 4)
        nmw = None if nmb is None else _words_T(nmb, L32 // 8)
    return l, keep, b2w, nmw


def _needs_counts(cfg: PipelineConfig) -> bool:
    return (cfg.with_artifacts or cfg.to_fasta_discard_n
            or (cfg.with_clip and not cfg.clip_keep_n))


def packed_fast_body(b2, planes, lengths, cfg: PipelineConfig,
                     has_n_plane: bool, tie_flag: bool = False,
                     seq_len: int | None = None):
    """The fully-packed decisions step on tensors of one device: ``b2``
    uint8 ``[B, ceil(L/4)]``, ``planes`` uint8 ``[B, P, ceil(L/8)]`` (the
    N plane first when ``has_n_plane``, then the ``_thresholds`` planes),
    ``lengths`` ``[B]``; ``seq_len`` is the true column count (default:
    all the columns ``b2`` holds).  Returns ``(l, keep, fragile)``: final
    lengths (0 where discarded), the keep mask, and the DP's tie_fragile
    flags (all False without the clipper or ``tie_flag``)."""
    B = b2.shape[0]
    Le = b2.shape[1] * 4 if seq_len is None else seq_len
    l, keep, b2w, nmw = packed_quality_stage(b2, planes, lengths, cfg,
                                             has_n_plane)
    fragile = torch.zeros(B, dtype=torch.bool, device=b2.device)
    if cfg.with_clip:
        res = align_batch_packed(b2w, nmw, l, cfg.adapter, L=Le,
                                 tie_flag=tie_flag)
        i_cut = adapter_cutoff_index(res, l)
        new_len = clip_cut_lengths(i_cut, l)
        if tie_flag:
            fragile = res["tie_fragile"]
    else:
        new_len = l

    has_n = torch.zeros(B, dtype=torch.bool, device=b2.device)
    worst = None
    if _needs_counts(cfg):
        worst, ncnt = packed_counts(b2w, nmw, new_len)
        has_n = ncnt > 0

    if cfg.with_clip:
        keep &= clip_write_mask(i_cut, new_len, has_n,
                                min_length=cfg.clip_minlen,
                                keep_n=cfg.clip_keep_n)
        l = new_len  # noqa: E741
    if cfg.with_artifacts:
        keep &= ~(worst >= l - 3)
    if cfg.to_fasta_discard_n:
        keep &= ~has_n
    l = torch.where(keep, l, 0).to(torch.int32)  # noqa: E741
    return l, keep, fragile


def _stats_counts(cfg: PipelineConfig, counts, what: str):
    """The ``counts`` column a body needs: required with ``with_stats``
    (a TypeError without it, as the reference's steps take it as an
    argument then), not read otherwise."""
    if cfg.with_stats and counts is None:
        raise TypeError("%s with with_stats needs the counts column" % what)
    return counts


def packed_decisions_pipeline(cfg: PipelineConfig, b2, planes, lengths, *,
                              has_n_plane: bool, device,
                              tie_flag: bool = False,
                              seq_len: int | None = None, counts=None):
    """Decisions for one 2-bit packed chunk (host numpy arrays or
    tensors), computed on ``device``: ``(l, keep, fragile)`` tensors.
    ``seq_len`` is the longest read's length (default: all the columns
    ``b2`` holds).  A chunk inside :func:`packed_fast_ok` takes the
    fully-packed body (K1 or K3, and K2); any other (an adapter outside
    ACGTN or of H_pad > 72, or the stats reduction) takes
    :func:`packed_pipeline_body` (K4).  With ``cfg.with_stats`` the
    reads' ``counts`` are required and the per-cycle counts are appended:
    ``(l, keep, fragile, count)``."""
    _stats_counts(cfg, counts, "packed_decisions_pipeline")
    if seq_len is None:
        seq_len = b2.shape[1] * 4
    dev = torch.device(device)
    b2, planes, lengths = (torch.as_tensor(a).to(dev)
                           for a in (b2, planes, lengths))
    if packed_fast_ok(cfg, seq_len):
        return packed_fast_body(b2, planes, lengths, cfg, has_n_plane,
                                tie_flag=tie_flag, seq_len=seq_len)
    if counts is not None:
        counts = torch.as_tensor(counts).to(dev)
    return packed_pipeline_body(b2, planes, lengths, cfg, seq_len=seq_len,
                                two_bit=True, has_n_plane=has_n_plane,
                                tie_flag=tie_flag, counts=counts)


def pipeline_body(bases, quals, lengths, cfg: PipelineConfig,
                  tie_flag: bool = False, counts=None):
    """One fused step over an unpacked batch on its device: every
    per-read tool of the chain applied back to back.  Returns ``(bases,
    quals, l, keep, fragile)``: the transformed batch, final lengths (0
    where discarded), the keep mask, and the DP's tie_fragile flags (all
    False without the clipper or ``tie_flag``); with ``cfg.with_stats``
    the reads' ``counts`` are required and the per-cycle nucleotide
    counts of the kept reads follow: ``(..., fragile, count)``."""
    _stats_counts(cfg, counts, "pipeline_body")
    b, q, l = bases, quals, lengths.to(torch.int32)  # noqa: E741
    b, q, l, keep = transforms.trimmer(b, q, l, last=cfg.trim_last)  # noqa: E741
    if cfg.with_filter:
        keep &= transforms.quality_filter_keep(
            q, l, min_quality=cfg.filter_q, min_percent=cfg.filter_p)
    if cfg.with_qtrim:
        b, q, l, k2 = transforms.quality_trimmer(  # noqa: E741
            b, q, l, threshold=cfg.trim_q, min_len=cfg.trim_minlen)
        keep &= k2
    if cfg.with_mask:
        b, _, _ = transforms.masker(b, q, l, threshold=cfg.mask_q,
                                    mask_char=ord("N"))
    fragile = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    if cfg.with_clip:
        out = clip_batch(
            b, q, l, adapter=cfg.adapter, min_length=cfg.clip_minlen,
            keep_delta=0, discard_non_clipped=False, discard_clipped=False,
            keep_n=cfg.clip_keep_n, show_adapter_only=False,
            min_adapter_len=0, tie_flag=tie_flag)
        b, q, l, wrote = out[:4]  # noqa: E741
        if tie_flag:
            fragile = out[5]
        keep &= wrote
    if cfg.with_artifacts:
        keep &= transforms.artifacts_keep(b, l)
    if cfg.to_fasta_discard_n:
        keep &= ~transforms.contains_n(b, l)
    l = torch.where(keep, l, 0).to(torch.int32)  # noqa: E741
    if cfg.with_stats:
        return b, q, l, keep, fragile, stats_ops.counts_only(b, l, counts)
    return b, q, l, keep, fragile


def fused_pipeline(cfg: PipelineConfig):
    """The reference's single-device step: a callable over ``(bases,
    quals, lengths, counts)`` tensors of one device returning ``(bases,
    quals, l, keep, count)``, where ``count`` is the per-cycle counts of
    the kept reads with ``cfg.with_stats`` and zeros ``[L, 6]`` without,
    as in the reference."""

    def step(bases, quals, lengths, counts):
        b, q, l, keep, _fragile, *count = pipeline_body(  # noqa: E741
            bases, quals, lengths, cfg, counts=counts)
        if not count:
            count = [torch.zeros((b.shape[1], stats_ops.NSLOTS),
                                 dtype=torch.int32, device=b.device)]
        return b, q, l, keep, count[0]

    return step


def decisions_pipeline(cfg: PipelineConfig, bases, quals, lengths, *,
                       device, tie_flag: bool = False, counts=None):
    """Ship decisions, not data: :func:`pipeline_body` on ``device`` for a
    padded batch (host numpy arrays or tensors), returning only ``(l,
    keep, fragile)`` per read, and ``count`` after them with
    ``cfg.with_stats``.  Every byte edit of the chain (the masker's) is
    re-applied on the host at render time."""
    _stats_counts(cfg, counts, "decisions_pipeline")
    dev = torch.device(device)
    bases, quals, lengths = (torch.as_tensor(a).to(dev)
                             for a in (bases, quals, lengths))
    if counts is not None:
        counts = torch.as_tensor(counts).to(dev)
    return pipeline_body(bases, quals, lengths, cfg, tie_flag=tie_flag,
                         counts=counts)[2:]


# ---------------------------------------------------------------------------
# Packed uploads: 2-bit (pure ACGTN) or 4-bit base codes + 1-bit planes
# ---------------------------------------------------------------------------
#
# The decisions never need raw quality values: the filter, trimmer and
# masker compare against static thresholds, so one `qual < t` bit per base
# and threshold suffices, and bases draw from the reference's alphabet
# (ACGTN + optional U/lowercase): 4 bits, or 2 bits plus an N plane for
# pure uppercase ACGTN.  Byte edits are re-applied on the host at render.

_ALPHABET = b"ACGTNUacgtnu"
_CODE_LUT = np.zeros(256, np.uint8)
for _i, _ch in enumerate(_ALPHABET, start=1):
    _CODE_LUT[_ch] = _i
_ASCII_LUT = np.zeros(16, np.uint8)
_ASCII_LUT[1:len(_ALPHABET) + 1] = np.frombuffer(_ALPHABET, np.uint8)
_IS_ACGTN = np.zeros(256, bool)
for _ch in b"\0ACGTN":
    _IS_ACGTN[_ch] = True


def _native_ok(*arrays) -> bool:
    return native.LIB is not None and all(
        a.flags["C_CONTIGUOUS"] for a in arrays)


def scan_alphabet(bases: np.ndarray) -> tuple[bool, bool]:
    """(pure_acgtn, has_n) for a chunk, one pass (native when available)."""
    if _native_ok(bases):
        return native.scan_alphabet(bases)
    return bool(_IS_ACGTN[bases].all()), bool((bases == ord("N")).any())


def pack_batch2(bases: np.ndarray, quals: np.ndarray, cfg: PipelineConfig,
                n_plane: bool = True):
    """2-bit pack for pure-ACGTN chunks: bases -> [B, ceil(L/4)] uint8
    (A=0 C=1 G=2 T=3; N/PAD positions carry garbage), planes ->
    [B, 1+T, ceil(L/8)] with plane 0 = `base == N` and planes 1.. the
    `qual < t` thresholds.  With ``n_plane=False`` (chunk verified N-free)
    the N plane is omitted.  Native when available; the numpy version is
    layout-identical."""
    if _native_ok(bases, quals):
        return native.pack2(bases, quals, _thresholds(cfg), n_plane)
    B, L = bases.shape  # noqa: E741
    codes = np.clip(_CODE_LUT[bases].astype(np.int16) - 1, 0, 3).astype(
        np.uint8)
    rem = (-L) % 4
    if rem:
        codes = np.concatenate([codes, np.zeros((B, rem), np.uint8)], axis=1)
    b2 = ((codes[:, 0::4] << 6) | (codes[:, 1::4] << 4)
          | (codes[:, 2::4] << 2) | codes[:, 3::4])
    head = [np.packbits(bases == ord("N"), axis=1)] if n_plane else []
    planes = np.stack(
        head + [np.packbits(quals < t, axis=1) for t in _thresholds(cfg)],
        axis=1)
    return b2, planes


def pack_batch(bases: np.ndarray, quals: np.ndarray, cfg: PipelineConfig):
    """4-bit pack: bases -> codes [B, ceil(L/2)] uint8 (``_ALPHABET``
    index + 1, 0 = PAD), quals -> one `qual < t` plane per distinct
    threshold [B, T, ceil(L/8)] (MSB-first).  Native when available; the
    numpy version is layout-identical."""
    if _native_ok(bases, quals):
        return native.pack4(bases, quals, _thresholds(cfg))
    B, L = bases.shape  # noqa: E741
    codes = _CODE_LUT[bases]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((B, 1), np.uint8)], axis=1)
    b4 = (codes[:, 0::2] << 4) | codes[:, 1::2]
    planes = np.stack(
        [np.packbits(quals < t, axis=1) for t in _thresholds(cfg)], axis=1)
    return b4, planes


def _unpack_planes(planes, le: int):
    """[B, P, nb] uint8 planes -> [B, P, le] bool (MSB-first bits)."""
    B, P = planes.shape[:2]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=planes.device)
    bits = (planes[:, :, :, None] >> shifts) & 1
    return bits.reshape(B, P, -1)[:, :, :le].bool()


def _unpack2(b2, planes, has_n_plane: bool = True):
    """Invert pack_batch2 on the device -> (ASCII bases [B, Le], q_lt
    [B, T, Le]) with Le = 4 * b2.shape[1]; positions beyond the true L
    hold garbage letters that every consumer masks out by length."""
    B = b2.shape[0]
    le = b2.shape[1] * 4
    codes = torch.stack([(b2 >> 6) & 3, (b2 >> 4) & 3, (b2 >> 2) & 3,
                         b2 & 3], dim=2).reshape(B, le).long()
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8,
                         device=b2.device)[codes]
    if planes.shape[1] == 0:  # no thresholds and no N plane shipped
        return bases, torch.zeros((B, 0, le), dtype=torch.bool,
                                  device=b2.device)
    all_planes = _unpack_planes(planes, le)
    if has_n_plane:
        bases = torch.where(all_planes[:, 0], ord("N"), bases).to(
            torch.uint8)
        return bases, all_planes[:, 1:]
    return bases, all_planes


def _unpack4(b4, planes):
    """Invert pack_batch on the device -> (ASCII bases [B, Le], q_lt bool
    [B, T, Le]) with Le = 2 * b4.shape[1] (>= the true L; the surplus
    column is PAD and masked out by length everywhere)."""
    B = b4.shape[0]
    le = b4.shape[1] * 2
    codes = torch.stack([(b4 >> 4) & 0xF, b4 & 0xF], dim=2).reshape(
        B, le).long()
    bases = torch.from_numpy(_ASCII_LUT).to(b4.device)[codes]
    if planes.shape[1] == 0:  # no thresholds shipped
        return bases, torch.zeros((B, 0, le), dtype=torch.bool,
                                  device=b4.device)
    return bases, _unpack_planes(planes, le)


def packed_pipeline_body(b4, planes, lengths, cfg: PipelineConfig,
                         seq_len: int | None = None, two_bit: bool = False,
                         has_n_plane: bool | None = None,
                         tie_flag: bool = False, counts=None):
    """:func:`pipeline_body` on a packed upload, unpacked on the device:
    decisions-identical to it.  ``seq_len`` is the true (pre-packing) L;
    ``two_bit`` selects the pack_batch2 layout; ``has_n_plane=False``
    (2-bit only) means the chunk was verified N-free and the N plane was
    not shipped.  Returns ``(l, keep, fragile)``; with ``cfg.with_stats``
    the reads' ``counts`` are required and the per-cycle counts of the
    kept reads (``[seq_len or Le, 6]``) follow."""
    _stats_counts(cfg, counts, "packed_pipeline_body")
    if has_n_plane is None:
        has_n_plane = two_bit
    lengths = lengths.to(torch.int32)
    b, q_lt = (_unpack2(b4, planes, has_n_plane) if two_bit
               else _unpack4(b4, planes))
    if seq_len is not None and seq_len < b.shape[1]:
        b = b[:, :seq_len]
        q_lt = q_lt[:, :, :seq_len]
    thr = {t: i for i, t in enumerate(_thresholds(cfg))}
    l = lengths  # noqa: E741
    iota = torch.arange(b.shape[1], dtype=torch.int32,
                        device=b.device)[None, :]
    keep = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)

    if cfg.trim_last != 0:  # fastx_trimmer -l (positional; quals untouched)
        l = l.clamp(max=cfg.trim_last)  # noqa: E741
    in_len = iota < l[:, None]

    if cfg.with_filter:
        # fastq_quality_filter: |{qual < q}| <= len*(100-p)/100
        below = (in_len & q_lt[:, thr[cfg.filter_q]]).sum(
            dim=1, dtype=torch.int32)
        keep &= below <= (l * (100 - cfg.filter_p)) // 100

    if cfg.with_qtrim:
        # fastq_quality_trimmer: drop the 3' run of qual < t
        passing = in_len & ~q_lt[:, thr[cfg.trim_q]]
        pos1 = torch.where(passing, iota + 1, 0)
        new_len = (pos1.max(dim=1).values if pos1.shape[1]
                   else torch.zeros_like(l)).to(torch.int32)
        keep &= (new_len > 0) & (new_len >= cfg.trim_minlen)
        l = new_len  # noqa: E741
        in_len = iota < l[:, None]

    if cfg.with_mask:
        # fastq_masker: the clipper/artifacts stages see the masked bases
        masked = in_len & q_lt[:, thr[cfg.mask_q]]
        b = torch.where(masked, ord("N"), b).to(torch.uint8)
    b = torch.where(in_len, b, 0).to(torch.uint8)

    fragile = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    if cfg.with_clip:
        dummy_q = torch.zeros(b.shape, dtype=torch.int8, device=b.device)
        out = clip_batch(
            b, dummy_q, l, adapter=cfg.adapter, min_length=cfg.clip_minlen,
            keep_delta=0, discard_non_clipped=False, discard_clipped=False,
            keep_n=cfg.clip_keep_n, show_adapter_only=False,
            min_adapter_len=0, tie_flag=tie_flag)
        b, _, l, wrote = out[:4]  # noqa: E741
        if tie_flag:
            fragile = out[5]
        keep &= wrote
    if cfg.with_artifacts:
        keep &= transforms.artifacts_keep(b, l)
    if cfg.to_fasta_discard_n:
        keep &= ~transforms.contains_n(b, l)
    l = torch.where(keep, l, 0).to(torch.int32)  # noqa: E741
    if cfg.with_stats:
        return l, keep, fragile, stats_ops.counts_only(b, l, counts)
    return l, keep, fragile

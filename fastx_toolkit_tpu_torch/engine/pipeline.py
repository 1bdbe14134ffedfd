"""The fused preprocessing chain's configuration and its packed decisions
body.

Counterpart of ``fastx_toolkit_tpu/engine/pipeline.py``: ``PipelineConfig``
(same fields and defaults, ``:51-82``), ``_thresholds`` (``:171-179``) and
the fully-packed decisions path (``:418-636``).  The body never builds an
unpacked ``[B, L]`` representation:

* quality filter  — popcount over the ``qual < q`` plane bytes;
* quality trimmer — the last passing position by lowest-set-bit tricks;
* masker          — one OR of its plane into the effective-N plane;
* clipper DP      — K1 (``kernels/align_cuda.py``) on the 2-bit words and
  the N|mask plane;
* artifacts / N   — K2 (``kernels/counts_cuda.py``).

The same body runs on the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.align_cuda import adapter_codes, align_batch_packed, packed12_ok
from ..kernels.counts_cuda import packed_counts
from ..ops.clipper import adapter_cutoff_index, clip_cut_lengths, clip_write_mask


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
    """The port's gate for the packed decisions body (which takes the
    2-bit upload): no stats reduction, and, with the clipper, an ACGTN
    adapter and reads of ``Le`` columns inside K1's bounds.  Any batch
    size."""
    if cfg.with_stats:
        return False
    if cfg.with_clip:
        return (adapter_codes(cfg.adapter) is not None
                and packed12_ok(Le, len(cfg.adapter)))
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


def packed_decisions_pipeline(cfg: PipelineConfig, b2, planes, lengths, *,
                              has_n_plane: bool, device,
                              tie_flag: bool = False,
                              seq_len: int | None = None):
    """Decisions for one 2-bit packed chunk (host numpy arrays or
    tensors), computed on ``device``: ``(l, keep, fragile)`` tensors.
    ``seq_len`` is the longest read's length (default: all the columns
    ``b2`` holds).

    Raises NotImplementedError for configurations outside the packed
    body's gate (:func:`packed_fast_ok`): the unpacked decisions path and
    the wider DP kernels are later port slices."""
    if seq_len is None:
        seq_len = b2.shape[1] * 4
    if not packed_fast_ok(cfg, seq_len):
        raise NotImplementedError(
            "this chain is outside the packed decisions body (stats, or an "
            "adapter outside ACGTN / over 31 bases, or reads over 511 bp "
            "with the clipper): the unpacked path and DP kernels K3/K4 are "
            "a later port slice")
    dev = torch.device(device)
    b2, planes, lengths = (torch.as_tensor(a).to(dev)
                           for a in (b2, planes, lengths))
    return packed_fast_body(b2, planes, lengths, cfg, has_n_plane,
                            tie_flag=tie_flag, seq_len=seq_len)

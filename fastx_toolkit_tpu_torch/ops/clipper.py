"""fastx_clipper decision logic on tensors.

Counterpart of ``fastx_toolkit_tpu/ops/clipper.py``: the
adapter_cutoff_index heuristics (FASTX-Toolkit fastx_clipper.cpp:159-241),
the clip/discard cascade (:282-319), the legacy stale-matrix emulation and
``clip_batch``, the whole clipper on a padded batch.  The reference's
``_align_dispatch`` is :func:`..kernels.align_unpacked_cuda.
align_batch_unpacked` itself: K4 for a CUDA batch at any B (the
reference's 1024/2048-row tile padding is gone), its plain version for a
CPU batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.align_unpacked_cuda import align_batch_unpacked
from . import transforms


def adapter_cutoff_index(res, lengths, *, min_adapter_len: int = 0):
    """-1 = no acceptable alignment, else the query index to cut at (the
    alignment's query_start)."""
    size = res["neutral"] + res["matches"] + res["mismatches"] + res["gaps"]
    m = res["matches"]
    pct = torch.where(size > 0, (m * 100) // size.clamp(min=1), 0)
    ok = size != 0
    if min_adapter_len > 0:
        ok &= size >= min_adapter_len
    r1 = (res["query_end"] == lengths - 1) & (res["mismatches"] == 0)
    r2 = (size > 5) & (res["target_start"] == 0) & (pct >= 75)
    r3 = (size > 11) & (pct >= 80)
    r4 = (res["query_end"] >= lengths - 2) & (size <= 5) & (m >= 3)
    accept = ok & (r1 | r2 | r3 | r4)
    return torch.where(accept, res["query_start"], -1)


def clip_cut_lengths(i, lengths, keep_delta: int = 0):
    """Post-clip lengths from the cutoff index (fastx_clipper.cpp:282-285;
    ``keep_delta`` already includes the adapter length when > 0)."""
    cut = torch.where(i > 0, i + keep_delta, i)
    return torch.where(cut > 0, torch.minimum(lengths, cut),
                       lengths).to(torch.int32)


def _categories(i, new_len, has_n, *, min_length: int, keep_n: bool,
                discard_non_clipped: bool, discard_clipped: bool):
    """The discard cascade's classes, first match wins."""
    c_zero = i == 0
    c_short = ~c_zero & (new_len < min_length)
    c_nonclip = ~c_zero & ~c_short & (i == -1) & discard_non_clipped
    c_clip = ~c_zero & ~c_short & ~c_nonclip & (i > 0) & discard_clipped
    c_n = ~c_zero & ~c_short & ~c_nonclip & ~c_clip & has_n & (not keep_n)
    return c_zero, c_short, c_nonclip, c_clip, c_n


def clip_write_mask(i, new_len, has_n, *, min_length: int, keep_n: bool):
    """The fused chain's discard cascade as a write mask: no adapter-only
    reads (cut at 0), none shorter than ``min_length``, and, unless
    ``keep_n``, none with an N."""
    c_zero, c_short, _nonclip, _clip, c_n = _categories(
        i, new_len, has_n, min_length=min_length, keep_n=keep_n,
        discard_non_clipped=False, discard_clipped=False)
    return ~(c_zero | c_short | c_n)


def legacy_effective_query(bases, lengths, carry=None):
    """Emulate the reference's grow-only DP matrix + reused query buffer
    (numpy, copied from the reference).

    The C++ engine's matrices only grow (sequence_alignment.cpp:131-153)
    and its _query_sequence member string is assigned per record into the
    same heap buffer, so for a read shorter than the widest read seen so
    far the DP scans STALE BYTES of earlier reads beyond the current
    read's terminator.  That is deterministic: position x of record i
    holds the byte written by the last record j <= i with len_j >= x
    (record j writes read[0..len_j-1] plus '\\0' at len_j, and a padded
    row is already 0 there).  Returns (effective_bases, widths, carry')
    where widths[i] is the running max length (the matrix width the C
    used for record i) and carry' = (last_row_bytes, width) seeds the
    next streamed chunk.
    """
    bases = np.asarray(bases)
    lengths = np.asarray(lengths, dtype=np.int64)
    B, L = bases.shape
    run_max = np.maximum.accumulate(lengths)
    if carry is not None:
        prev_row, prev_w = carry
        run_max = np.maximum(run_max, prev_w)
    W = int(run_max.max()) if B else 0
    if bases.shape[1] < W:
        bases = np.pad(bases, ((0, 0), (0, W - bases.shape[1])))
    col = np.arange(W)
    # last writer index per (row, column); -1 = none yet
    writer = np.where(lengths[:, None] >= col[None, :], np.arange(B)[:, None],
                      -1)
    writer = np.maximum.accumulate(writer, axis=0)
    eff = np.where(writer >= 0, bases[np.maximum(writer, 0), col[None, :]], 0)
    if carry is not None:
        prev_row, prev_w = carry
        seed = np.zeros(W, np.uint8)
        seed[: min(len(prev_row), W)] = prev_row[: min(len(prev_row), W)]
        eff = np.where(writer >= 0, eff, seed[None, :]).astype(np.uint8)
    eff = eff.astype(np.uint8)
    new_carry = (eff[-1].copy(), int(run_max[-1])) if B else carry
    return eff, run_max.astype(np.int32), new_carry


def clip_batch(bases, quals, lengths, *, adapter: bytes, min_length: int,
               keep_delta: int, discard_non_clipped: bool,
               discard_clipped: bool, keep_n: bool,
               show_adapter_only: bool, min_adapter_len: int,
               align_bases=None, align_lengths=None, tie_flag: bool = False):
    """The whole clipper on a padded batch, on the batch's device.

    Returns (bases, quals, new_lengths, write_mask, category) where
    category codes the discard class for the verbose report:
    0=written, 1=adapter-at-zero, 2=too-short, 3=non-clipped(-c),
    4=clipped(-C), 5=contains-N; with ``tie_flag`` also the DP's
    tie_fragile flags.  With -k, adapter-at-zero reads are written
    instead of the normal survivors (fastx_clipper.cpp:288-319).

    ``align_bases``/``align_lengths`` optionally feed the DP a different
    view of the reads (the legacy emulation,
    :func:`legacy_effective_query`); the cutoff heuristics and the clip
    itself always use the true reads and lengths, like the reference.
    """
    ab = bases if align_bases is None else align_bases
    al = lengths if align_lengths is None else align_lengths
    res = align_batch_unpacked(ab, al, adapter, tie_flag=tie_flag)
    i = adapter_cutoff_index(res, lengths, min_adapter_len=min_adapter_len)
    new_len = clip_cut_lengths(i, lengths, keep_delta)
    has_n = transforms.contains_n(bases, new_len)

    classes = _categories(
        i, new_len, has_n, min_length=min_length, keep_n=keep_n,
        discard_non_clipped=discard_non_clipped,
        discard_clipped=discard_clipped)
    cat = torch.zeros(bases.shape[0], dtype=torch.int32, device=bases.device)
    for code, c in enumerate(classes, start=1):
        cat = torch.where(c, code, cat)
    write = classes[0] if show_adapter_only else cat == 0

    bases, quals = transforms._zero_pad(bases, quals, new_len)
    if tie_flag:
        return bases, quals, new_len, write, cat, res["tie_fragile"]
    return bases, quals, new_len, write, cat

"""Host float32 re-decision for tie_fragile reads.

Counterpart of ``fastx_toolkit_tpu/engine/hostfix.py:22-128``.  The
device DP runs exact-decimal arithmetic; the reference's float32 engine
can resolve an exact tie that involves a neutral (N) score differently.
The DP kernels flag such reads (tie_fragile) and the line engine, the
pipeline CLI and the clipper CLI re-decide only those here, with the
native codec's bit-faithful float32 clipper DP (``native.clip_float``),
so the output matches the reference byte for byte; without the native
codec it takes the numpy float32 engine (``kernels/align.
align_batch_float32``), which gives the same results.  Pure numpy: the
fragile subset is tiny and costs no device round trip.
"""

from __future__ import annotations

import numpy as np

from ..core import native
from ..kernels.align import _N, align_batch_float32


def cutoff_index_np(res, lengths, min_adapter_len: int = 0):
    """numpy adapter_cutoff_index (ops/clipper.py), for host fixes."""
    size = res["neutral"] + res["matches"] + res["mismatches"] + res["gaps"]
    m = res["matches"]
    pct = np.where(size > 0, (m * 100) // np.maximum(size, 1), 0)
    ok = size != 0
    if min_adapter_len > 0:
        ok &= size >= min_adapter_len
    qe, ts = res["query_end"], res["target_start"]
    r1 = (qe == lengths - 1) & (res["mismatches"] == 0)
    r2 = (size > 5) & (ts == 0) & (pct >= 75)
    r3 = (size > 11) & (pct >= 80)
    r4 = (qe >= lengths - 2) & (size <= 5) & (m >= 3)
    accept = ok & (r1 | r2 | r3 | r4)
    return np.where(accept, res["query_start"], -1).astype(np.int64)


def clip_decide_np(bases, lengths, adapter: bytes, *, min_length: int,
                   keep_delta: int, discard_non_clipped: bool,
                   discard_clipped: bool, keep_n: bool,
                   show_adapter_only: bool, min_adapter_len: int,
                   align_bases=None, align_lengths=None):
    """Float32 clipper outcome for a subset: ``(new_len, write, cat)``,
    mirroring ops/clipper.clip_batch's cascade exactly; ``align_bases`` /
    ``align_lengths`` feed the DP the legacy emulation's view of the
    reads."""
    bases = np.asarray(bases, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    ab = bases if align_bases is None else np.asarray(align_bases, np.uint8)
    al = lengths if align_lengths is None else np.asarray(align_lengths,
                                                         np.int64)
    if native.LIB is not None:
        res = native.clip_float(ab, al, adapter)
    else:
        res = align_batch_float32(ab, al, adapter)
    i = cutoff_index_np(res, lengths, min_adapter_len)
    cut = np.where(i > 0, i + keep_delta, i)
    new_len = np.where(cut > 0, np.minimum(lengths, cut), lengths).astype(
        np.int32
    )
    cols = np.arange(bases.shape[1])[None, :]
    has_n = ((bases == _N) & (cols < new_len[:, None])).any(axis=1)
    cat = np.zeros(len(new_len), np.int32)
    c_zero = i == 0
    c_short = ~c_zero & (new_len < min_length)
    c_nonclip = ~c_zero & ~c_short & (i == -1) & discard_non_clipped
    c_clip = ~c_zero & ~c_short & ~c_nonclip & (i > 0) & discard_clipped
    c_n = ~c_zero & ~c_short & ~c_nonclip & ~c_clip & has_n & (not keep_n)
    cat[c_zero] = 1
    cat[c_short] = 2
    cat[c_nonclip] = 3
    cat[c_clip] = 4
    cat[c_n] = 5
    write = c_zero if show_adapter_only else (cat == 0)
    return new_len, write, cat


def host_decide(cfg, bases, quals, lengths):
    """The fused chain's decisions for a subset of reads, on the host, with
    the float32 clip: ``(final_len, keep)``, identical to the device step
    except for float tie resolutions."""
    bases = np.asarray(bases, np.uint8)
    quals = np.asarray(quals, np.int16)
    n, L = bases.shape
    l = np.asarray(lengths, np.int32).copy()  # noqa: E741
    keep = np.ones(n, bool)
    cols = np.arange(L)[None, :]

    if cfg.trim_last != 0:
        l = np.minimum(l, cfg.trim_last)  # noqa: E741
    in_len = cols < l[:, None]
    if cfg.with_filter:
        below = ((quals < cfg.filter_q) & in_len).sum(axis=1)
        keep &= below <= (l * (100 - cfg.filter_p)) // 100
    if cfg.with_qtrim:
        passing = in_len & (quals >= cfg.trim_q)
        pos1 = np.where(passing, cols + 1, 0)
        new_l = pos1.max(axis=1).astype(np.int32)
        keep &= (new_l > 0) & (new_l >= cfg.trim_minlen)
        l = new_l  # noqa: E741
        in_len = cols < l[:, None]
    eff = bases
    if cfg.with_mask:
        eff = np.where(in_len & (quals < cfg.mask_q), np.uint8(_N), eff)
    eff = np.where(in_len, eff, 0).astype(np.uint8)

    if cfg.with_clip:
        new_len, write, _cat = clip_decide_np(
            eff, l, cfg.adapter, min_length=cfg.clip_minlen, keep_delta=0,
            discard_non_clipped=False, discard_clipped=False,
            keep_n=cfg.clip_keep_n, show_adapter_only=False,
            min_adapter_len=0,
        )
        keep &= write
        l = new_len  # noqa: E741
    if cfg.with_artifacts:
        in2 = cols < l[:, None]
        worst = np.zeros(n, np.int64)
        for ch in b"ACGT":
            worst = np.maximum(worst, ((eff == ch) & in2).sum(axis=1))
        keep &= ~(worst >= l - 3)
    if cfg.to_fasta_discard_n:
        keep &= ~(((eff == _N) & (cols < l[:, None])).any(axis=1))
    l = np.where(keep, l, 0).astype(np.int32)  # noqa: E741
    return l, keep

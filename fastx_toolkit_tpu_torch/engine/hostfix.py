"""Host float32 re-decision for tie_fragile reads.

Counterpart of ``fastx_toolkit_tpu/engine/hostfix.py:22-128``.  The
device DP runs exact-decimal arithmetic; the reference's float32 engine
can resolve an exact tie that involves a neutral (N) score differently.
K1 flags such reads (tie_fragile) and the line engine re-decides only
those here, with the native codec's bit-faithful float32 clipper DP
(``native.clip_float``), so the output matches the reference byte for
byte.  Pure numpy: the fragile subset is tiny and costs no device round
trip.
"""

from __future__ import annotations

import numpy as np

from ..core import native
from ..kernels.align import _N


def cutoff_index_np(res, lengths):
    """numpy adapter_cutoff_index (ops/clipper.py)."""
    size = res["neutral"] + res["matches"] + res["mismatches"] + res["gaps"]
    m = res["matches"]
    pct = np.where(size > 0, (m * 100) // np.maximum(size, 1), 0)
    qe, ts = res["query_end"], res["target_start"]
    r1 = (qe == lengths - 1) & (res["mismatches"] == 0)
    r2 = (size > 5) & (ts == 0) & (pct >= 75)
    r3 = (size > 11) & (pct >= 80)
    r4 = (qe >= lengths - 2) & (size <= 5) & (m >= 3)
    accept = (size != 0) & (r1 | r2 | r3 | r4)
    return np.where(accept, res["query_start"], -1).astype(np.int64)


def clip_decide_np(bases, lengths, adapter: bytes, *, min_length: int,
                   keep_n: bool):
    """Float32 clipper outcome for a subset, ``(new_len, write)``: the
    fused chain's clip and discard cascade (ops/clipper.py; the clipper
    CLI's -d/-c/-C/-k/-M options are a later port slice)."""
    if native.LIB is None:
        raise RuntimeError("the float32 tie re-decision needs the native "
                           "codec (the numpy float32 DP is a later port "
                           "slice)")
    bases = np.asarray(bases, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    res = native.clip_float(bases, lengths, adapter)
    i = cutoff_index_np(res, lengths)
    new_len = np.where(i > 0, np.minimum(lengths, i), lengths).astype(
        np.int32
    )
    cols = np.arange(bases.shape[1])[None, :]
    has_n = ((bases == _N) & (cols < new_len[:, None])).any(axis=1)
    write = (i != 0) & (new_len >= min_length) & (keep_n | ~has_n)
    return new_len, write


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
        new_len, write = clip_decide_np(
            eff, l, cfg.adapter, min_length=cfg.clip_minlen,
            keep_n=cfg.clip_keep_n,
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

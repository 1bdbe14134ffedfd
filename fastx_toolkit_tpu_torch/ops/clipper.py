"""fastx_clipper decision logic on tensors.

Counterpart of ``fastx_toolkit_tpu/ops/clipper.py:70-110``: the
adapter_cutoff_index heuristics and the clip/discard cascade
(reference fastx_clipper.cpp:159-241, :282-319), as the fused chain uses
them.  The clipper CLI's -d/-c/-C/-k/-M options are a later port slice.
"""

from __future__ import annotations

import torch


def adapter_cutoff_index(res, lengths):
    """-1 = no acceptable alignment, else the query index to cut at (the
    alignment's query_start)."""
    size = res["neutral"] + res["matches"] + res["mismatches"] + res["gaps"]
    m = res["matches"]
    pct = torch.where(size > 0, (m * 100) // size.clamp(min=1), 0)
    r1 = (res["query_end"] == lengths - 1) & (res["mismatches"] == 0)
    r2 = (size > 5) & (res["target_start"] == 0) & (pct >= 75)
    r3 = (size > 11) & (pct >= 80)
    r4 = (res["query_end"] >= lengths - 2) & (size <= 5) & (m >= 3)
    accept = (size != 0) & (r1 | r2 | r3 | r4)
    return torch.where(accept, res["query_start"], -1)


def clip_cut_lengths(i, lengths):
    """Post-clip lengths from the cutoff index."""
    return torch.where(i > 0, torch.minimum(lengths, i),
                       lengths).to(torch.int32)


def clip_write_mask(i, new_len, has_n, *, min_length: int, keep_n: bool):
    """The clipper's discard cascade as a write mask: no adapter-only
    reads (cut at 0), none shorter than ``min_length``, and, unless
    ``keep_n``, none with an N."""
    write = (i != 0) & (new_len >= min_length)
    return write if keep_n else write & ~has_n

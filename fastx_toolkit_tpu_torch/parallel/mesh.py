"""Data-parallel sharding over a process group, and collective merges.

Counterpart of ``fastx_toolkit_tpu/parallel/mesh.py`` in PyTorch's SPMD
idiom.  The reference is a single-threaded, single-process streaming
program; reads are independent, so the only parallelism axis in this
domain is DATA parallelism over reads, plus collective reductions for
the global operators:

* per-read transforms (trim/filter/mask/clip/...) — each rank runs them
  on its own rows; no communication at all;
* fastx_quality_stats — per-rank scatter-add histograms merged with
  ``all_reduce`` SUM/MIN/MAX;
* fastx_collapser — a per-rank sort+segment dedup, then an all-gather of
  the (key words, counts, first) tables and a re-collapse (associative
  merge);
* barcode splitter — per-rank matching; per-identifier tallies summed.

Where the reference's ``shard_map`` splits one global array over its
``Mesh(('data',))``, here **each rank passes its own rows** (``shard_batch``
cuts a host batch into the same blocks as ``P('data')``).  Reductions and
the collapse table come back replicated on every rank; per-read outputs
are this rank's rows, and concatenated over the ranks in rank order they
equal the single-device function's on the whole batch.

The collectives run on the mesh's group (``DeviceMesh``, one dimension
named ``data``): NCCL for CUDA tensors, gloo for CPU tensors, by how the
process group was initialized (:func:`distributed_init`).  NCCL cannot
put two ranks on one GPU, so on a machine with one card the mesh has one
rank; the CLIs' host-level merges (``parallel/multihost``) run over gloo
on the host and share the card among any number of processes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import stats as stats_ops
from ..ops import transforms

_INT32_MAX = 2 ** 31 - 1


def distributed_init(**kwargs) -> None:
    """Initialize the default process group
    (``torch.distributed.init_process_group(**kwargs)``, e.g. ``backend=
    "nccl"`` or ``"gloo"``, ``init_method="tcp://host:port"``,
    ``world_size``, ``rank``).  A no-op when a group is up already, or,
    as in the reference, when it cannot form (running single-process)."""
    if dist.is_initialized():
        return
    try:
        dist.init_process_group(**kwargs)
    except (RuntimeError, ValueError):
        pass


def data_mesh(n_ranks: Optional[int] = None):
    """A 1-D ``DeviceMesh`` named ``("data",)`` over the first ``n_ranks``
    ranks of the process group (default: all), of the type of the device
    ``FASTX_TORCH_DEVICE`` names (default ``cuda``).  Raises when fewer
    ranks or devices are there than asked for."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device()
    world = dist.get_world_size() if dist.is_initialized() else 0
    n = n_ranks or world
    if world < n or n < 1:
        raise RuntimeError(
            "data_mesh(%s) needs %d ranks but the torch.distributed group "
            "has %d; bring the group up first (distributed_init), one "
            "process a rank" % (n_ranks, max(n, 1), world))
    if dev.type == "cuda" and torch.cuda.device_count() < 1:
        raise RuntimeError("data_mesh on cuda needs a CUDA device")
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=("data",))


def _group(mesh):
    return mesh.get_group("data")


def _rank(mesh) -> int:
    return mesh.get_local_rank("data")


def shard_batch(mesh, *arrays):
    """This rank's rows of each host array (numpy or tensor), on the
    mesh's device type: the block split of ``P('data')``, rows
    ``[r*B/n, (r+1)*B/n)``; ``B`` must split evenly, as in the
    reference."""
    n = mesh.size()
    r = _rank(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ValueError("shard_batch: %d rows do not split evenly over "
                             "%d ranks" % (t.shape[0], n))
        k = t.shape[0] // n
        out.append(t[r * k:(r + 1) * k].to(mesh.device_type))
    return tuple(out)


def _all_reduce(t, op, group):
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather_rows(t, group):
    """Every rank's rows of ``t`` (each rank the same shape), stacked in
    rank order along dim 0: the tiled all-gather."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    # all_gather_into_tensor, under its newer name where torch has one
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, t.contiguous(), group=group)
    return out


def sharded_stats(mesh, bases, quals, lengths, counts, *, is_fastq: bool):
    """Quality-stats reduction over the mesh: each rank's plain scatter
    reduction (``ops/stats.accumulate``) of its rows, merged with
    ``all_reduce`` SUM (count, hist, qsum), MIN (qmin) and MAX (qmax).
    Every rank's batch has the same width.  Returns ``(count, hist,
    qsum, qmin, qmax)``, replicated."""
    g = _group(mesh)
    count, hist, qsum, qmin, qmax = stats_ops.accumulate(
        bases, quals, lengths, counts, is_fastq=is_fastq)
    S, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX
    return (_all_reduce(count, S, g), _all_reduce(hist, S, g),
            _all_reduce(qsum, S, g), _all_reduce(qmin, MIN, g),
            _all_reduce(qmax, MAX, g))


def sharded_pipeline(mesh, *, adapter: bytes = b"CTGTAGGCACCATCAAT",
                     trim_last: int = 0, filter_q: int = 20,
                     filter_p: int = 50, trim_q: int = 20,
                     trim_minlen: int = 0, mask_q: int = 20,
                     clip_minlen: int = 5):
    """The fused read-preprocessing step, data-parallel over the mesh:
    fastx_trimmer -> fastq_quality_filter -> fastq_quality_trimmer ->
    fastq_masker -> fastx_clipper -> fastx_artifacts_filter, plus the
    per-cycle stats reduction summed over the ranks.

    Returns a fn (bases, quals, lengths, counts) -> (bases, quals,
    lengths, keep, stats_count): this rank's rows, and the counts of
    every rank's kept reads."""
    from ..engine.pipeline import PipelineConfig, pipeline_body

    cfg = PipelineConfig(
        adapter=adapter, trim_last=trim_last, filter_q=filter_q,
        filter_p=filter_p, trim_q=trim_q, trim_minlen=trim_minlen,
        mask_q=mask_q, clip_minlen=clip_minlen, with_stats=True,
    )

    def step(b, q, l, c):  # noqa: E741
        b, q, l, keep, _fragile, count = pipeline_body(  # noqa: E741
            b, q, l, cfg, counts=c)
        return b, q, l, keep, _all_reduce(count, dist.ReduceOp.SUM,
                                          _group(mesh))

    return step


def sharded_packed_pipeline(mesh, cfg=None, *, two_bit: bool = True,
                            has_n_plane: Optional[bool] = None,
                            seq_len: Optional[int] = None):
    """:func:`sharded_pipeline` over the packed upload
    (``engine.pipeline.pack_batch``/``pack_batch2``: 2- or 4-bit bases +
    1-bit quality threshold planes), unpacked on the device
    (``packed_pipeline_body``), with the stats counts summed over the
    ranks (zeros when ``cfg.with_stats`` is off, as in the reference).

    Returns a fn (packed_bases, planes, lengths, counts) -> (new_lengths,
    keep, stats_count)."""
    from ..engine.pipeline import PipelineConfig, packed_pipeline_body

    if cfg is None:
        cfg = PipelineConfig(with_stats=True)

    def step(b, p, l, c):  # noqa: E741
        out = packed_pipeline_body(b, p, l, cfg, seq_len=seq_len,
                                   two_bit=two_bit, has_n_plane=has_n_plane,
                                   counts=c if cfg.with_stats else None)
        if cfg.with_stats:
            count = out[3]
        else:
            le = b.shape[1] * (4 if two_bit else 2)
            if seq_len is not None and seq_len < le:
                le = seq_len
            count = torch.zeros((le, stats_ops.NSLOTS), dtype=torch.int32,
                                device=b.device)
        return out[0], out[1], _all_reduce(count, dist.ReduceOp.SUM,
                                           _group(mesh))

    return step


def _heads(w, c, f, collapse):
    """A collapse of rows ``(w, c, f)``: the sorted words, each segment's
    count and least first index at its head row, 0 and int32 max at the
    other rows."""
    perm, head, seg_id, seg_counts, seg_first = collapse(w, c, f)
    sid = seg_id.long()
    counts_at_head = torch.where(head, seg_counts[sid], 0).to(c.dtype)
    first_at_head = torch.where(head, seg_first[sid],
                                _INT32_MAX).to(torch.int32)
    return w[perm], counts_at_head, first_at_head


def sharded_collapse(mesh, words, counts, first_idx):
    """fastx_collapser over the mesh.

    Each rank dedups its rows locally (sort + segment-reduce), zeroing
    the counts of non-head rows; an all-gather then brings the (still
    sorted-within-rank) tables together and a global re-collapse merges
    them — the collapse operator is associative, so the result is
    identical to a single-device collapse.  ``first_idx`` holds the
    rows' global first-appearance indices; every rank passes the same
    number of rows.  Returns replicated ``(words_sorted, seg_counts,
    seg_first)`` of all the ranks' rows; rows with seg_counts == 0 are
    non-heads/padding."""
    from ..ops.collapse import collapse as _collapse

    g = _group(mesh)
    sw, ch, fh = _heads(words, counts, first_idx, _collapse)
    gw, gc, gf = (_all_gather_rows(t, g) for t in (sw, ch, fh))
    return _heads(gw, gc, gf, _collapse)


def sharded_barcode_counts(mesh, bases, lengths, barcodes, barcode_lens,
                           penalties, *, bol: bool, barcodes_length: int,
                           mismatches: int, n_idents: int, ident_of_barcode):
    """Barcode splitter tallies over the mesh: each rank matches its rows
    (``ops/transforms.barcode_match``) and the per-identifier counts are
    summed over the ranks (the record scatter itself is host-side file
    IO).  Returns (this rank's identifier per row, -1 where unmatched;
    the tally ``[n_idents + 1]``, replicated, its last slot the
    unmatched reads)."""
    dev = bases.device
    ident_map = torch.as_tensor(np.asarray(ident_of_barcode)).to(dev)
    best_idx, best_mm = transforms.barcode_match(
        bases, lengths, barcodes, barcode_lens, penalties,
        bol=bol, barcodes_length=barcodes_length)
    matched = (best_idx >= 0) & (best_mm <= mismatches)
    # (no barcode: every read unmatched, and no identifier to look up)
    looked = (ident_map[best_idx.clamp(min=0).long()] if len(ident_map)
              else torch.full_like(best_idx, n_idents))
    ident = torch.where(matched, looked, n_idents).long()
    tally = torch.zeros(n_idents + 1, dtype=torch.int32, device=dev)
    tally.index_add_(0, ident, torch.ones_like(ident, dtype=torch.int32))
    return (torch.where(matched, ident, -1).to(torch.int32),
            _all_reduce(tally, dist.ReduceOp.SUM, _group(mesh)))

"""fastx_collapser — collapse identical sequences to >rank-count records.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_collapser.py``
(FASTX-Toolkit's ``fastx_collapser.cpp``), byte for byte.  Tie order
among equal counts is first appearance (the reference's libstdc++ hash
order is implementation-defined; see ``ops/collapse.py``).

Two dedup engines with identical output (``FASTX_COLLAPSE_PATH=host|
device`` overrides the policy, ``engine/policy.py`` kind ``collapse``:
``host`` wherever the native codec is, on a card too):

* ``host``   — the native hash table (``native.DedupTable``), fed from
  raw line spans where a chunk passes validation
  (``_shared.line_fast_path``; collapsed FASTA counts from the names by
  ``native.counts_from_names``), else from the parsed batch;
* ``device`` — each parsed batch goes through ``ops/collapse.
  collapse_batch`` on the device ``FASTX_TORCH_DEVICE`` names (default
  ``cuda``), which shrinks it to its distinct sequences; a host dict
  merges the batches (count sum, least first appearance).

Output assembly is the reference's: final order (count descending, first
appearance ascending), the ``rank-count`` names, ``-v`` report.  In a
process group (``parallel/multihost``) each process collapses its own
byte range of the input on either engine; the tables are allgathered and
merged (counts summed, first appearances shifted by
``global_record_offset`` and the least kept), so every process holds the
single-process table, and only process 0 writes it.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_collapser \\
        [-h] [-v] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ...core import codec, native
from ...core.records import ReadBatch, StringColumn
from ...device import resolve_device
from ...engine import policy
from ...engine.pipeline import to_device
from ...ops import collapse
from ...parallel import multihost
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_collapser [-h] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-v]         = verbose: print short summary of input/output counts\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def collapse_path() -> str:
    """``FASTX_COLLAPSE_PATH=host|device`` over the engine policy."""
    return policy.resolve("collapse", os.environ.get("FASTX_COLLAPSE_PATH"))


def _host_table(reader, args):
    """The host engine: -> (key_offs, key_buf, uniq_counts, uniq_first,
    n_in_seq, n_in_reads)."""
    n_in_seq = n_in_reads = rec_base = 0
    table = native.DedupTable()
    try:
        # validation runs before insertion: the table must not see rows
        # of a chunk the full parser would reject
        fast = _shared.line_fast_path(reader, args)
        for chunk, line_base in reader.iter_chunks():
            fr = fast(chunk) if fast is not None else None
            if fr is not None:
                if reader.is_fastq:
                    counts = None
                    n_in_reads += len(fr)  # FASTQ multiplicity is 1
                else:
                    # collapsed multiplicities from the '>id-count' names
                    # (get_reads_count, fastx.c:475-495)
                    counts = native.counts_from_names(
                        fr.buf, fr.name_starts, fr.name_lens)
                    n_in_reads += int(counts.sum())
                table.insert_lines(fr.buf, fr.seq_starts, fr.seq_lens,
                                   rec_base, counts=counts)
                n_in_seq += len(fr)
                rec_base += len(fr)
                continue
            batch = reader.parse_chunk(chunk, line_base)
            table.insert(batch.bases, batch.lengths, batch.counts, rec_base)
            n_in_seq += len(batch)
            n_in_reads += int(batch.counts.sum())
            rec_base += len(batch)
        return table.extract() + (n_in_seq, n_in_reads)
    finally:
        table.close()


def _device_table(reader, device):
    """The device engine: a per-batch dedup on ``device``, merged on the
    host; same return as :func:`_host_table`."""
    n_in_seq = n_in_reads = rec_base = 0
    table: dict = {}
    for batch in reader:
        nb = len(batch)
        bases, _quals, _lengths, counts = to_device(batch)
        uniq_idx, uc, uf = collapse.collapse_batch(bases, counts, device)
        real = (uniq_idx < nb) & (uc > 0)
        uniq_idx, uc, uf = uniq_idx[real], uc[real], uf[real]
        bmat = np.asarray(batch.bases)
        blens = np.asarray(batch.lengths)
        for ridx, c, f in zip(uniq_idx, uc, uf):
            seq = bmat[ridx, : blens[ridx]].tobytes()
            ent = table.get(seq)
            if ent is None:
                table[seq] = [int(c), rec_base + int(f)]
            else:
                ent[0] += int(c)
        n_in_seq += nb
        n_in_reads += int(batch.counts.sum())
        rec_base += nb
    return _table_arrays(table) + (n_in_seq, n_in_reads)


def _table_arrays(table: dict):
    """A ``{seq: [count, first]}`` table as ``(key_offs, key_buf,
    uniq_counts, uniq_first)`` arrays, in the dict's order."""
    seqs = list(table.keys())
    uniq_counts = np.array([table[s][0] for s in seqs], np.int64)
    uniq_first = np.array([table[s][1] for s in seqs], np.int64)
    key_buf = (np.frombuffer(b"".join(seqs), np.uint8)
               if seqs else np.zeros(0, np.uint8))
    key_offs = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=key_offs[1:])
    return key_offs, key_buf, uniq_counts, uniq_first


def merge_tables(key_offs, key_buf, uniq_counts, uniq_first, n_in_seq,
                 n_in_reads):
    """The global table of a process group: each process collapsed its
    own byte-range shard, so its first-appearance indices shift by the
    global record offset (shards are file-ordered); the (seq -> count,
    first) tables are allgathered and merged associatively, so every
    process ends with the identical global table and the rank, count and
    tie-break order match a single-process run.  Same arguments and
    return as the engines' tables; the identity outside a process
    group."""
    info = multihost.shard_info()
    if not (info.active and info.collective):
        return (key_offs, key_buf, uniq_counts, uniq_first, n_in_seq,
                n_in_reads)
    offset = multihost.global_record_offset(n_in_seq)
    local = [
        (key_buf[key_offs[i]:key_offs[i + 1]].tobytes(),
         int(uniq_counts[i]), int(uniq_first[i]) + offset)
        for i in range(len(uniq_counts))
    ]
    merged: dict = {}
    for part in multihost.allgather_object(local):
        for s, c, f in part:
            ent = merged.get(s)
            if ent is None:
                merged[s] = [c, f]
            else:
                ent[0] += c
                ent[1] = min(ent[1], f)
    n_in_seq, n_in_reads = multihost.allsum(n_in_seq, n_in_reads)
    return _table_arrays(merged) + (n_in_seq, n_in_reads)


def tool_main(ctx: CliContext, argv) -> int:
    args = common.parse_cmdline(ctx, argv, "", None, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    device = resolve_device()
    if collapse_path() == "host":
        res = _host_table(reader, args)
    else:
        res = _device_table(reader, device)
    key_offs, key_buf, uniq_counts, uniq_first, n_in_seq, n_in_reads = (
        merge_tables(*res))

    uniq_counts = np.asarray(uniq_counts, np.int64)
    uniq_first = np.asarray(uniq_first, np.int64)
    n_uniq = len(uniq_counts)
    order = collapse.final_order(uniq_counts, uniq_first)
    uniq_counts = uniq_counts[order]

    # vectorized output assembly: the ordered keys gathered into a padded
    # matrix, the rank-count id column without Python loops
    key_lens = np.diff(key_offs)
    starts = np.ascontiguousarray(key_offs[:-1][order])
    lens = np.ascontiguousarray(key_lens[order])
    width = int(lens.max()) if n_uniq else 0
    if native.LIB is not None and n_uniq:
        out_bases = native.gather_rows(key_buf, starts, lens, width)
    else:
        out_bases = codec._gather_padded(key_buf, starts, lens, width)
    name_buf, name_offs = collapse.rank_count_column(uniq_counts)

    out = ReadBatch(
        bases=out_bases,
        quals=np.zeros((n_uniq, width), np.int8),
        lengths=lens.astype(np.int32),
        counts=uniq_counts.astype(np.int32),
        names=StringColumn(name_buf, name_offs),
        names2=None,
        is_fastq=False,
    )
    _shared.write_fasta(ctx, args, out, role="merged")

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Input: %d sequences (representing %d reads)\n"
                  % (n_in_seq, n_in_reads))
        rep.write("Output: %d sequences (representing %d reads)\n"
                  % (n_uniq, int(uniq_counts.sum())))
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

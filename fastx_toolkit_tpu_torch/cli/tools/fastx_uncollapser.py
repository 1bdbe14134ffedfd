"""fastx_uncollapser — expand collapsed records / tabular lines by count.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_uncollapser.py``
(FASTX-Toolkit's ``fastx_uncollapser.cpp``), byte for byte; host only.
FASTA input: each ``>rank-count`` record is repeated ``count`` times,
renamed to sequential read ordinals (``ops/collapse.ordinal_column``).
With ``-c N``: each line of a tabular file is repeated by the count in
its N-th tab-separated column.  Sharded runs (``parallel/multihost``)
read this process's record-aligned (FASTA) or line-aligned (tabular)
byte range; in a process group the FASTA ordinals stay global (a
counting pre-pass and ``global_record_offset``) and the ``-v`` counts
are allsum'd.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_uncollapser \\
        [-c N] [-h] [-v] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from ...core import codec
from ...core.records import StringColumn
from ...core.errors import FastxError
from ...ops.collapse import ordinal_column
from ...parallel import multihost
from .. import common
from ..common import CliContext, ExitWithStatus, errx
from . import _shared

USAGE = (
    "usage: fasta_uncollapser [-c N] [-h] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-v]         = verbose: print short summary of input/output counts\n"
    "   [-c N]       = Assume input is a tabular file (not FASTA file),\n"
    "                  And the collapsed identifier (e.g. '1-1000') is on column N.\n"
    "   [-i INFILE]  = FASTA/Tabular input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Tabular output file. default is STDOUT.\n"
    "\n"
)

_STRTOUL_RE = re.compile(rb"^[ \t\n\v\f\r]*\+?([0-9]+)")


def extract_collapsed_read_count(text: bytes) -> int:
    """fastx_uncollapser.cpp:101-123."""
    value = text
    dash = text.find(b"-")
    if dash != -1:
        if dash + 1 < len(text):
            value = text[dash + 1:]
        else:
            return 1
    # strtoul, then the whole string must be consumed (*endptr == 0)
    m = _STRTOUL_RE.match(value)
    if m and m.end() == len(value):
        count = int(m.group(1))
        if count > 0:
            return count
    return 1


def _uncollapse_fasta(ctx, args):
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_ONLY)
    writer = common.OutputWriter(ctx, args)
    n_in_seq = n_reads = n_out = 0
    info = multihost.shard_info()
    if info.active and info.collective:
        # output IDs are globally sequential read ordinals, so each shard
        # must know the total read count of all earlier shards: cheap
        # counting pre-pass over this shard, then an exclusive prefix sum
        local_reads = 0
        for batch in _shared.BatchReader(ctx, args, filetype=codec.FASTA_ONLY):
            local_reads += int(np.asarray(batch.counts, dtype=np.int64).sum())
        n_out = multihost.global_record_offset(local_reads)
    id_base = n_out
    for batch in reader:
        counts = np.asarray(batch.counts, dtype=np.int64)
        idx = np.repeat(np.arange(len(batch)), counts)
        out = batch.take(idx)
        out.counts = np.ones(len(idx), np.int32)
        out.names = StringColumn(*ordinal_column(n_out, len(idx)))
        n_in_seq += len(batch)
        n_reads += int(counts.sum())
        n_out += len(idx)
        writer.write(codec.render(out, out_fastq=False))
    writer.close()

    if args.verbose:
        n_in_seq, n_reads, n_emitted = multihost.allsum(
            n_in_seq, n_reads, n_out - id_base)
        rep = common.report_stream(ctx, args)
        rep.write("Input: %d sequences (representing %d reads)\n"
                  % (n_in_seq, n_reads))
        rep.write("Output: %d sequences (representing %d reads)\n"
                  % (n_emitted, n_reads))


def _open_line_stream(ctx, args):
    """Open the tabular input, shard-aware: in sharded runs this process
    reads only its line-aligned byte range of the file.  Returns
    ``(stream, remaining)``: the bytes left to read, None when whole."""
    if args.input_filename == "-" or args.input_filename.startswith("-"):
        stream = ctx.stdin
    else:
        try:
            stream = open(args.input_filename, "rb")
        except OSError as e:
            print("%s: failed to open input file '%s': %s"
                  % (ctx.prog, args.input_filename, e.strerror),
                  file=ctx.stderr)
            raise ExitWithStatus(1)
    info = multihost.shard_info()
    remaining = None
    if info.active:
        if (
            stream is ctx.stdin
            or not (hasattr(stream, "seekable") and stream.seekable())
            or not hasattr(stream, "fileno")
        ):
            raise FastxError(
                "sharded/multi-host input requires a seekable input file "
                "(-i FILE), not STDIN or a pipe"
            )
        size = os.fstat(stream.fileno()).st_size
        lo, hi = multihost.shard_line_range(stream, size, info)
        stream.seek(lo)
        remaining = hi - lo
    return stream, remaining


def _uncollapse_tabular(ctx, args, column: int):
    stream, remaining = _open_line_stream(ctx, args)
    block_bytes = int(os.environ.get("FASTX_TPU_BLOCK_BYTES", 64 * 1024 * 1024))
    writer = common.OutputWriter(ctx, args)
    input_count = 0
    output_count = 0
    carry = b""
    eof = False
    while not eof:
        want = block_bytes if remaining is None else min(block_bytes,
                                                         remaining)
        block = stream.read(want) if want > 0 else b""
        if remaining is not None:
            remaining -= len(block)
        eof = not block
        data = carry + block
        lines = data.split(b"\n")
        carry = lines.pop()  # incomplete tail (b"" when data ends in \n)
        if eof and carry:
            lines.append(carry)  # final line without trailing newline
            carry = b""
        out = []
        for line in lines:
            input_count += 1
            # gtextutils String_Tokenize semantics: consecutive, leading
            # and trailing tabs give no empty tokens, so an empty line has
            # zero columns (fastx_uncollapser.cpp:150)
            tokens = [t for t in line.split(b"\t") if t]
            if len(tokens) < column:
                if out:  # the reference streams: lines before the bad one
                    writer.write(b"".join(x + b"\n" for x in out))
                print(
                    "Input error in file '%s' line %d: got only %d columns, "
                    "but collapsed identifier column (-c) is %d"
                    % (args.input_filename, input_count, len(tokens), column),
                    file=ctx.stderr,
                )
                raise ExitWithStatus(1)
            count = extract_collapsed_read_count(tokens[column - 1])
            output_count += count
            out.extend([line] * count)
        if out:
            writer.write(b"".join(x + b"\n" for x in out))
    writer.close()

    if args.verbose:
        input_count, output_count = multihost.allsum(input_count,
                                                     output_count)
        rep = common.report_stream(ctx, args)
        rep.write("Input: %d lines (with collapsed sequence identifiers)\n"
                  % input_count)
        rep.write("Output: %d lines\n" % output_count)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"column": 0}

    def cb(args, opt, arg):
        if opt == "c":
            st["column"] = common.c_strtoul(arg)
            if st["column"] <= 0:
                errx(ctx, "Invalid column number (-c %s)" % arg)

    args = common.parse_cmdline(ctx, argv, "c:", cb, USAGE)
    if st["column"] == 0:
        _uncollapse_fasta(ctx, args)
    else:
        _uncollapse_tabular(ctx, args, st["column"])
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

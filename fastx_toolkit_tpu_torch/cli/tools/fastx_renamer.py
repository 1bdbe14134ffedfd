"""fastx_renamer — rename ids to the sequence itself or a counter.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_renamer.py``
(FASTX-Toolkit's ``fastx_renamer.c``; the default rename type is SEQ: the
C global enum is zero-initialized), byte for byte; host only.  COUNT
names come from ``ops/collapse.ordinal_column``.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_renamer \\
        [-n TYPE] [-h] [-z] [-v] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

import numpy as np

from ...core import codec
from ...core.records import StringColumn
from ...ops.collapse import ordinal_column
from ...parallel import multihost
from .. import common
from ..common import CliContext, errx
from . import _shared

USAGE = (
    "usage: fastx_renamer [-n TYPE] [-h] [-z] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-n TYPE]    = rename type:\n"
    "                  SEQ - use the nucleotides sequence as the name.\n"
    "                  COUNT - use simply counter as the name.\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"type": "SEQ"}

    def cb(args, opt, arg):
        if opt == "n":
            # the C compares strncmp(optarg, "SEQ", 3) / strncmp(optarg,
            # "COUNT", 5): prefixes match
            if arg.startswith("SEQ"):
                st["type"] = "SEQ"
            elif arg.startswith("COUNT"):
                st["type"] = "COUNT"
            else:
                errx(ctx, "Uknown rename type [-n]: '%s'" % arg)

    args = common.parse_cmdline(ctx, argv, "n:", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    writer = common.OutputWriter(ctx, args)
    n = 0
    counter = 0
    for batch in reader:
        if st["type"] == "SEQ":
            mat = np.asarray(batch.bases, dtype=np.uint8)
            names = StringColumn.from_padded(mat, np.asarray(batch.lengths))
        else:
            names = StringColumn(*ordinal_column(counter, len(batch)))
            counter += len(batch)
        batch.names = names
        if batch.is_fastq:
            batch.names2 = names
        n += int(batch.counts.sum())
        writer.write(_shared.render_same_as_input(args, batch))
    writer.close()

    if args.verbose:
        (n,) = multihost.allsum(n)
        rep = common.report_stream(ctx, args)
        rep.write("Renamed: %d reads.\n" % n)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

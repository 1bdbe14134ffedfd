"""fastq_quality_converter — ASCII <-> numeric quality re-encoding.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastq_quality_converter.py``
(FASTX-Toolkit's ``fastq_quality_converter.c``), byte for byte, on the
host only (parse and render with the port's codec).  The ``-v`` counts
are this process's own: the port runs one process.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastq_quality_converter \\
        [-h] [-a] [-n] [-z] [-v] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastq_quality_converter [-h] [-a] [-n] [-z] [-i INFILE] [-f OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-a]         = Output ASCII quality scores (default).\n"
    "   [-n]         = Output numeric quality scores.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"ascii": True}

    def cb(args, opt, arg):
        if opt == "a":
            st["ascii"] = True
        elif opt == "n":
            st["ascii"] = False

    args = common.parse_cmdline(ctx, argv, "an", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTQ_ONLY)
    writer = common.OutputWriter(ctx, args)
    n = 0
    for batch in reader:
        n += int(batch.counts.sum())
        writer.write(
            codec.render(
                batch, out_fastq=True, ascii_qual=st["ascii"], q_offset=args.q_offset
            )
        )
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        _shared.in_out_report(rep, n, n)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

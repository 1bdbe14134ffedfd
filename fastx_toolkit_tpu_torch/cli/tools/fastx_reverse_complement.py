"""fastx_reverse_complement.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_reverse_complement.py``
(FASTX-Toolkit's ``fastx_reverse_complement.c``), byte for byte.  There
is no raw-line fast path: every batch is parsed and reversed by
``ops/transforms.reverse_complement`` on the device ``FASTX_TORCH_DEVICE``
names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_reverse_complement \\
        [-h] [-z] [-v] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec
from ...device import resolve_device
from ...ops import transforms
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_reverse_complement [-h] [-r] [-z] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    args = common.parse_cmdline(ctx, argv, "", None, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n = 0
    for batch in reader:
        bases, quals, lengths, _counts = _shared.device_batch(batch, device)
        b2, q2 = transforms.reverse_complement(bases, quals, lengths,
                                               is_fastq=batch.is_fastq)
        batch.bases = b2.cpu().numpy()
        batch.quals = q2.cpu().numpy()
        n += int(batch.counts.sum())
        writer.write(_shared.render_same_as_input(args, batch))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Printing Reverse-Complement Sequences.\n")
        _shared.in_out_report(rep, n, n)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

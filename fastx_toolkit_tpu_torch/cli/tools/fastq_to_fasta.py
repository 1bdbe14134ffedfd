"""fastq_to_fasta — FASTQ to FASTA converter.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastq_to_fasta.py``
(FASTX-Toolkit's ``fastq_to_fasta.c``: discards reads containing 'N'
unless ``-n``, renames ids to output ordinals with ``-r``), byte for
byte.  Clean chunks take the raw-line fast path (``native.rows_with_n``,
``native.render_lines``) when the engine policy says ``host`` and ``-r``
is not given; every other chunk is parsed and decided by
``ops/transforms.fastq_to_fasta_keep`` on the device
``FASTX_TORCH_DEVICE`` names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastq_to_fasta \\
        [-h] [-r] [-n] [-v] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec, native
from ...core.records import StringColumn
from ...device import resolve_device
from ...ops import transforms
from ...ops.collapse import ordinal_column
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastq_to_fasta [-h] [-r] [-n] [-v] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-r]         = Rename sequence identifiers to numbers.\n"
    "   [-n]         = keep sequences with unknown (N) nucleotides.\n"
    "                  Default is to discard such sequences.\n"
    "   [-v]         = Verbose - report number of sequences.\n"
    "                  If [-o] is specified,  report will be printed to STDOUT.\n"
    "                  If [-o] is not specified (and output goes to STDOUT),\n"
    "                  report will be printed to STDERR.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    state = {"rename": False, "discard_n": True}

    def cb(args, opt, arg):
        if opt == "n":
            state["discard_n"] = False
        elif opt == "r":
            state["rename"] = True

    args = common.parse_cmdline(ctx, argv, "rn", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTQ_ONLY)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_out = 0
    # -r renumbers output records; the classic path owns the ordinal
    fast = None if state["rename"] else _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            keep = None
            kept = len(fr)
            if state["discard_n"]:
                keep = 1 - native.rows_with_n(fr.buf, fr.seq_starts, fr.seq_lens)
                kept = int(keep.sum())
            n_in += len(fr)
            n_out += kept
            writer.write(native.render_lines(
                fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
                fr.qual_starts, fr.name2_starts, fr.name2_lens,
                fr.seq_lens, keep, out_fastq=False, q_offset=args.q_offset,
            ))
            continue
        batch = reader.parse_chunk(chunk, line_base)
        bases, _quals, lengths, _counts = _shared.device_batch(batch, device)
        keep = transforms.fastq_to_fasta_keep(
            bases, lengths, discard_n=state["discard_n"]).cpu().numpy()
        out = batch.select(keep)
        if state["rename"]:
            out.names = StringColumn(*ordinal_column(n_out, len(out)))
        n_in += int(batch.counts.sum())
        n_out += int(out.counts.sum())
        writer.write(codec.render(out, out_fastq=False))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Input: %d reads.\n" % n_in)
        rep.write("Output: %d reads.\n" % n_out)
        if state["discard_n"]:
            discarded = n_in - n_out
            rep.write(
                "discarded %d (%d%%) low-quality reads.\n"
                % (discarded, (discarded * 100) // n_in if n_in else 0)
            )
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

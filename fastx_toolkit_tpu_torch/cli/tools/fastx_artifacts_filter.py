"""fastx_artifacts_filter — drop near-homopolymer artifact reads.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_artifacts_filter.py``
(FASTX-Toolkit's ``fastx_artifacts_filter.c``), byte for byte.  Clean
chunks take the raw-line fast path (``native.artifacts_rows``; FASTA
frames render through ``_shared.write_fasta_frame``) when the engine
policy says ``host``; every other chunk is parsed and decided by
``ops/transforms.artifacts_keep`` on the device ``FASTX_TORCH_DEVICE``
names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_artifacts_filter \\
        [-h] [-v] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec, native
from ...device import resolve_device
from ...ops import transforms
from ...parallel import multihost
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_artifacts_filter [-h] [-v] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-v]         = Verbose - report number of processed reads.\n"
    "                  If [-o] is specified,  report will be printed to STDOUT.\n"
    "                  If [-o] is not specified (and output goes to STDOUT),\n"
    "                  report will be printed to STDERR.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    args = common.parse_cmdline(ctx, argv, "", None, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_out = 0
    fast = _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            keep = native.artifacts_rows(fr.buf, fr.seq_starts, fr.seq_lens)
            if reader.is_fastq:
                n_in += len(fr)
                n_out += int(keep.sum())
                writer.write(native.render_lines(
                    fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
                    fr.qual_starts, fr.name2_starts, fr.name2_lens,
                    fr.seq_lens, keep, out_fastq=True,
                    q_offset=args.q_offset,
                ))
            else:
                counts = native.counts_from_names(
                    fr.buf, fr.name_starts, fr.name_lens
                ) if args.verbose else None
                di, do = _shared.write_fasta_frame(
                    writer, args, fr, fr.seq_lens, keep, counts=counts,
                )
                n_in += di
                n_out += do
            continue
        batch = reader.parse_chunk(chunk, line_base)
        bases, _quals, lengths, _counts = _shared.device_batch(batch, device)
        keep = transforms.artifacts_keep(bases, lengths).cpu().numpy()
        out = batch.select(keep)
        n_in += int(batch.counts.sum())
        n_out += int(out.counts.sum())
        writer.write(_shared.render_same_as_input(args, out))
    writer.close()

    if args.verbose:
        n_in, n_out = multihost.allsum(n_in, n_out)
        rep = common.report_stream(ctx, args)
        _shared.in_out_report(rep, n_in, n_out)
        discarded = n_in - n_out
        rep.write(
            "discarded %d (%d%%) artifact reads.\n"
            % (discarded, (discarded * 100) // n_in if n_in else 0)
        )
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

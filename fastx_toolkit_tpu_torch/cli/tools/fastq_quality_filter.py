"""fastq_quality_filter — percentile quality filter.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastq_quality_filter.py``
(FASTX-Toolkit's ``fastq_quality_filter.c``), byte for byte.  Clean
chunks take the raw-line fast path (``native.quality_decide`` and
``native.render_lines``) when the engine policy says ``host`` (the
default; ``FASTX_LINEPATH=off`` or ``FASTX_TPU_NO_LINEPATH=1`` turn it
off); every other chunk is parsed and decided by
``ops/transforms.quality_filter_keep`` on the device ``FASTX_TORCH_DEVICE``
names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastq_quality_filter \\
        [-h] [-v] [-q N] [-p N] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec, native
from ...device import resolve_device
from ...ops import transforms
from .. import common
from ..common import CliContext, errx
from . import _shared

USAGE = (
    "usage: fastq_quality_filter [-h] [-v] [-q N] [-p N] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-q N]       = Minimum quality score to keep.\n"
    "   [-p N]       = Minimum percent of bases that must have [-q] quality.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "   [-v]         = Verbose - report number of sequences.\n"
    "                  If [-o] is specified,  report will be printed to STDOUT.\n"
    "                  If [-o] is not specified (and output goes to STDOUT),\n"
    "                  report will be printed to STDERR.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"q": 0, "p": 0}

    def cb(args, opt, arg):
        if opt == "q":
            st["q"] = common.c_strtoul(arg)
        elif opt == "p":
            st["p"] = common.c_strtoul(arg)
            if st["p"] <= 0 or st["p"] > 100:
                errx(ctx, "Invalid percent value (-p %s)" % arg)

    args = common.parse_cmdline(ctx, argv, "q:p:", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTQ_ONLY)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_out = 0
    fast = _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            # raw-line fast path: decide and render from the line spans;
            # FASTQ multiplicity is always 1
            _nl, keep, _m = native.quality_decide(
                fr.buf, fr.qual_starts, fr.seq_lens, args.q_offset,
                filter_q=st["q"], filter_p=st["p"],
            )
            n_in += len(fr)
            n_out += int(keep.sum())
            writer.write(native.render_lines(
                fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
                fr.qual_starts, fr.name2_starts, fr.name2_lens,
                fr.seq_lens, keep, out_fastq=True, q_offset=args.q_offset,
            ))
            continue
        batch = reader.parse_chunk(chunk, line_base)
        _bases, quals, lengths, _counts = _shared.device_batch(batch, device)
        keep = transforms.quality_filter_keep(
            quals, lengths, min_quality=st["q"], min_percent=st["p"]
        ).cpu().numpy()
        out = batch.select(keep)
        n_in += int(batch.counts.sum())
        n_out += int(out.counts.sum())
        writer.write(_shared.render_same_as_input(args, out))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Quality cut-off: %d\n" % st["q"])
        rep.write("Minimum percentage: %d\n" % st["p"])
        _shared.in_out_report(rep, n_in, n_out)
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

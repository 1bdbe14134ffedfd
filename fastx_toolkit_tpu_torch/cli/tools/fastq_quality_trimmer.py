"""fastq_quality_trimmer — 3' low-quality run trimming.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastq_quality_trimmer.py``
(FASTX-Toolkit's ``fastq_quality_trimmer.c``), byte for byte.  Clean
chunks take the raw-line fast path (``native.quality_decide``) when the
engine policy says ``host``; every other chunk is parsed and trimmed by
``ops/transforms.quality_trimmer`` on the device ``FASTX_TORCH_DEVICE``
names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastq_quality_trimmer \\
        [-h] [-v] [-t N] [-l N] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

from ...core import codec, native
from ...device import resolve_device
from ...ops import transforms
from ...parallel import multihost
from .. import common
from ..common import CliContext, errx
from . import _shared

USAGE = (
    "usage: fastq_quality_trimmer [-h] [-v] [-t N] [-l N] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-t N]       = Quality threshold - nucleotides with lower \n"
    "                  quality will be trimmed (from the end of the sequence).\n"
    "   [-l N]       = Minimum length - sequences shorter than this (after trimming)\n"
    "                  will be discarded. Default = 0 = no minimum length. \n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTQ input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTQ output file. default is STDOUT.\n"
    "   [-v]         = Verbose - report number of sequences.\n"
    "                  If [-o] is specified,  report will be printed to STDOUT.\n"
    "                  If [-o] is not specified (and output goes to STDOUT),\n"
    "                  report will be printed to STDERR.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"t": 0, "l": 0}

    def cb(args, opt, arg):
        if opt == "l":
            st["l"] = common.c_strtoul(arg)
        elif opt == "t":
            st["t"] = common.c_atoi(arg)

    args = common.parse_cmdline(ctx, argv, "t:l:", cb, USAGE)
    if st["t"] == 0:
        errx(ctx, "Missing minimum quality threshold value (-t)")

    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTQ_ONLY)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_out = 0
    fast = _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            new_lens, keep, _m = native.quality_decide(
                fr.buf, fr.qual_starts, fr.seq_lens, args.q_offset,
                trim_q=st["t"], trim_minlen=st["l"],
            )
            n_in += len(fr)
            n_out += int(keep.sum())
            writer.write(native.render_lines(
                fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
                fr.qual_starts, fr.name2_starts, fr.name2_lens,
                new_lens, keep, out_fastq=True, q_offset=args.q_offset,
            ))
            continue
        batch = reader.parse_chunk(chunk, line_base)
        bases, quals, lengths, _counts = _shared.device_batch(batch, device)
        b2, q2, l2, keep = transforms.quality_trimmer(
            bases, quals, lengths, threshold=st["t"], min_len=st["l"]
        )
        n_in += int(batch.counts.sum())
        batch.bases = b2.cpu().numpy()
        batch.quals = q2.cpu().numpy()
        batch.lengths = l2.cpu().numpy()
        out = batch.select(keep.cpu().numpy())
        n_out += int(out.counts.sum())
        writer.write(_shared.render_same_as_input(args, out))
    writer.close()

    if args.verbose:
        n_in, n_out = multihost.allsum(n_in, n_out)
        rep = common.report_stream(ctx, args)
        rep.write("Minimum Quality Threshold: %d\n" % st["t"])
        if st["l"] > 0:
            rep.write("Minimum Length: %d\n" % st["l"])
        else:
            rep.write("No minimum Length\n")
        _shared.in_out_report(rep, n_in, n_out)
        discarded = n_in - n_out
        rep.write(
            "discarded %d (%d%%) too-short reads.\n"
            % (discarded, (discarded * 100) // n_in if n_in else 0)
        )
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

"""fastq_masker — mask low-quality bases.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastq_masker.py``
(FASTX-Toolkit's ``fastq_masker.c``), byte for byte.  Clean chunks take
the raw-line fast path (``native.quality_decide`` counts, the renderer
masks) when the engine policy says ``host``; every other chunk is parsed
and masked by ``ops/transforms.masker`` on the device
``FASTX_TORCH_DEVICE`` names (default ``cuda``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastq_masker \\
        [-h] [-v] [-q N] [-r C] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

import numpy as np

from ...core import codec, native
from ...device import resolve_device
from ...ops import transforms
from .. import common
from ..common import CliContext, errx
from . import _shared

USAGE = (
    "usage: fastq_masker [-h] [-v] [-q N] [-r C] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-q N]       = Quality threshold - nucleotides with lower quality will be masked\n"
    "                  Default is 10.\n"
    "   [-r C]       = Replace low-quality nucleotides with character C. Default is 'N'\n"
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
    st = {"q": 10, "r": "N"}

    def cb(args, opt, arg):
        if opt == "q":
            st["q"] = common.c_atoi(arg)
            if st["q"] < -40:
                errx(ctx, "Invalid minimum length value (-q %s)" % arg)
        elif opt == "r":
            if len(arg) != 1:
                errx(ctx, "[-r] parameter requires a single character as value")
            st["r"] = arg

    args = common.parse_cmdline(ctx, argv, "q:r:", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTQ_ONLY)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = masked_reads = masked_nucs_total = 0
    fast = _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            _nl, _k, masked = native.quality_decide(
                fr.buf, fr.qual_starts, fr.seq_lens, args.q_offset,
                mask_q=st["q"],
            )
            n_in += len(fr)
            masked_reads += int((masked > 0).sum())
            masked_nucs_total += int(masked.sum())
            writer.write(native.render_lines(
                fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
                fr.qual_starts, fr.name2_starts, fr.name2_lens,
                fr.seq_lens, None, out_fastq=True, q_offset=args.q_offset,
                mask_thr=st["q"], mask_char=ord(st["r"]),
            ))
            continue
        batch = reader.parse_chunk(chunk, line_base)
        bases, quals, lengths, _counts = _shared.device_batch(batch, device)
        b2, masked_any, masked_nucs = transforms.masker(
            bases, quals, lengths, threshold=st["q"], mask_char=ord(st["r"])
        )
        batch.bases = b2.cpu().numpy()
        n_in += int(batch.counts.sum())
        masked_reads += int(
            (masked_any.cpu().numpy() * np.asarray(batch.counts)).sum()
        )
        masked_nucs_total += int(masked_nucs.sum())
        writer.write(_shared.render_same_as_input(args, batch))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Minimum Quality Threshold: %d\n" % st["q"])
        rep.write("Low-quality nucleotides replaced with '%s'\n" % st["r"])
        _shared.in_out_report(rep, n_in, n_in)
        rep.write("Masked reads: %d\n" % masked_reads)
        rep.write("Masked nucleotides: %d\n" % masked_nucs_total)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

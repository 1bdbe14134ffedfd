"""fasta_nucleotide_changer — DNA<->RNA (T<->U) conversion.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fasta_nucleotide_changer.py``
(FASTX-Toolkit's ``fasta_nucleotide_changer.c``), byte for byte.  There
is no raw-line fast path: every batch is parsed and changed by
``ops/transforms.nucleotide_changer`` on the device
``FASTX_TORCH_DEVICE`` names (default ``cuda``).  The abort on a
forbidden nucleotide compares against the padded width
(``engine.pipeline.padded_width``), as in the reference.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fasta_nucleotide_changer \\
        [-h] [-z] [-v] [-i INFILE] [-o OUTFILE] [-r] [-d]
"""

from __future__ import annotations

import sys

import numpy as np

from ...core import codec
from ...device import resolve_device
from ...ops import transforms
from .. import common
from ..common import CliContext, errx
from . import _shared

USAGE = (
    "usage: fasta_nucleotide_changer [-h] [-z] [-v] [-i INFILE] [-o OUTFILE] [-r] [-d]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-v]         = Verbose mode. Prints a short summary.\n"
    "                  with [-o], summary is printed to STDOUT.\n"
    "                  Otherwise, summary is printed to STDERR.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "   [-r]         = DNA-to-RNA mode - change T's into U's.\n"
    "   [-d]         = RNA-to-DNA mode - change U's into T's.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"dna": False, "rna": False}

    def cb(args, opt, arg):
        if opt == "d":
            st["dna"] = True
        elif opt == "r":
            st["rna"] = True

    args = common.parse_cmdline(ctx, argv, "rd", cb, USAGE)
    if not st["dna"] and not st["rna"]:
        errx(ctx, "Please specify either RNA mode (-r) or DNA mode (-d)")
    if st["dna"] and st["rna"]:
        errx(ctx, "RNA mode (-r) and DNA mode (-d) can not be used together.")

    reader = _shared.BatchReader(
        ctx, args, filetype=codec.FASTA_OR_FASTQ, allow_n=True, allow_u=True
    )
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n = 0
    rec_base = 0
    total_changes = 0
    for batch in reader:
        bases, _quals, lengths, _counts = _shared.device_batch(batch, device)
        b2, changes, first_bad = transforms.nucleotide_changer(
            bases, lengths, rna_mode=st["rna"])
        b2 = b2.cpu().numpy()
        bad_rows = np.flatnonzero(first_bad.cpu().numpy()
                                  < np.asarray(batch.lengths))
        if len(bad_rows):
            i = int(bad_rows[0])
            # the reference streams: records before the offending one were
            # already written before the abort
            partial = batch.take(np.arange(i))
            partial.bases = b2[:i]
            writer.write(codec.render(partial, out_fastq=False))
            writer.close()
            # input_line_number at the time the record was processed = its
            # last line (fasta_nucleotide_changer.c:104-106)
            lpr = 4 if batch.is_fastq else 2
            line = lpr * (rec_base + i + 1)
            nuc_to = "T" if st["dna"] else "U"
            mode = "RNA-to-DNA" if st["dna"] else "DNA-to-RNA"
            errx(
                ctx,
                "Error: found '%s' nucleotide on line %d. (input should not contain '%s' nucleotides in %s mode)"
                % (nuc_to, line, nuc_to, mode),
            )
        batch.bases = b2
        n += int(batch.counts.sum())
        total_changes += int(changes.sum())
        rec_base += len(batch)
        writer.write(codec.render(batch, out_fastq=False))
    writer.close()

    if args.verbose:
        rep = common.report_stream(ctx, args)
        rep.write("Mode: %s\n" % ("RNA-to-DNA" if st["dna"] else "DNA-to-RNA"))
        _shared.in_out_report(rep, n, n)
        rep.write("Nucleotides changed: %d\n" % total_changes)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

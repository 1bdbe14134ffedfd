"""fastx_trimmer — positional/end trimming.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_trimmer.py``
(FASTX-Toolkit's ``fastx_trimmer.c``), byte for byte.  Clean chunks take
the raw-line fast path (positional trims are span arithmetic; FASTA
frames render through ``_shared.write_fasta_frame``) when the engine
policy says ``host``; every other chunk is parsed and trimmed by
``ops/transforms.trimmer`` on the device ``FASTX_TORCH_DEVICE`` names
(default ``cuda``).  ``-f`` slices the padded width
(``engine.pipeline.padded_width``), as in the reference.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_trimmer \\
        [-h] [-f N] [-l N] [-t N] [-m MINLEN] [-z] [-v] [-Q N] \\
        [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import sys

import numpy as np

from ...core import codec, native
from ...device import resolve_device
from ...ops import transforms
from ...parallel import multihost
from .. import common
from ..common import CliContext, errx
from . import _shared

MAX_SEQ_LINE_LENGTH = 25000

USAGE = (
    "usage: fastx_trimmer [-h] [-f N] [-l N] [-t N] [-m MINLEN] [-z] [-v] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-f N]       = First base to keep. Default is 1 (=first base).\n"
    "   [-l N]       = Last base to keep. Default is entire read.\n"
    "   [-t N]       = Trim N nucleotides from the end of the read.\n"
    "                  '-t'  can not be used with '-l' and '-f'.\n"
    "   [-m MINLEN]  = With [-t], discard reads shorter than MINLEN.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"first": 1, "last": 0, "trim_end": 0, "min_len": 0,
          "by_pos": False, "from_end": False}

    def cb(args, opt, arg):
        if opt == "f":
            v = common.c_strtoul(arg)
            if v <= 0 or v >= MAX_SEQ_LINE_LENGTH:
                errx(ctx, "Invalid number bases to keep (-f %s)" % arg)
            st["first"] = v
            st["by_pos"] = True
        elif opt == "l":
            v = common.c_strtoul(arg)
            if v <= 0 or v >= MAX_SEQ_LINE_LENGTH:
                errx(ctx, "Invalid number bases to keep (-l %s)" % arg)
            st["last"] = v
            st["by_pos"] = True
        elif opt == "t":
            v = common.c_strtoul(arg)
            if v <= 0 or v >= MAX_SEQ_LINE_LENGTH:
                errx(ctx, "Invalid number bases to trim (-t %s)" % arg)
            st["trim_end"] = v
            st["from_end"] = True
        elif opt == "m":
            v = common.c_strtoul(arg)
            if v <= 0 or v >= MAX_SEQ_LINE_LENGTH:
                errx(ctx, "Invalid minimum length value (-m %s)" % arg)
            st["min_len"] = v

    args = common.parse_cmdline(ctx, argv, "l:f:t:m:", cb, USAGE)
    if st["by_pos"] and st["from_end"]:
        errx(ctx, "[-t], [-f] and [-l] options can not be used together. Use [-t] or [-l,-f]")

    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_out = 0
    fast = _shared.line_fast_path(reader, args)
    for chunk, line_base in reader.iter_chunks():
        fr = fast(chunk) if fast is not None else None
        if fr is not None:
            # raw-line fast path: -f shifts the sequence (and, for FASTQ,
            # quality) spans, -l/-t adjust lengths (transforms.trimmer's
            # semantics)
            nl = fr.seq_lens.copy()
            keep = np.ones(len(fr), bool)
            if st["last"] != 0:
                np.minimum(nl, st["last"], out=nl)
            off = st["first"] - 1
            if off:
                keep &= nl >= st["first"]
                nl = nl - off
            if st["trim_end"] > 0:
                keep &= nl > st["trim_end"]
                nl = nl - st["trim_end"]
                keep &= nl >= st["min_len"]
            nl = np.where(keep, np.maximum(nl, 0), 0)
            if reader.is_fastq:
                n_in += len(fr)
                n_out += int(keep.sum())
                writer.write(native.render_lines(
                    fr.buf, fr.name_starts, fr.name_lens,
                    fr.seq_starts + off, fr.qual_starts + off,
                    fr.name2_starts, fr.name2_lens,
                    nl, keep.astype(np.uint8), out_fastq=True,
                    q_offset=args.q_offset,
                ))
            else:
                # FASTA reports weigh by collapsed multiplicity; the
                # counts scan is paid only when -v reads them
                counts = native.counts_from_names(
                    fr.buf, fr.name_starts, fr.name_lens
                ) if args.verbose else None
                di, do = _shared.write_fasta_frame(
                    writer, args, fr, nl, keep,
                    seq_starts=fr.seq_starts + off, counts=counts,
                )
                n_in += di
                n_out += do
            continue
        batch = reader.parse_chunk(chunk, line_base)
        bases, quals, lengths, _counts = _shared.device_batch(batch, device)
        b2, q2, l2, keep = transforms.trimmer(
            bases, quals, lengths,
            first=st["first"], last=st["last"],
            trim_end=st["trim_end"], min_len=st["min_len"],
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
        if st["first"] != 1 or st["last"] != 0:
            rep.write("Trimming: base %d to %d\n" % (st["first"], st["last"]))
        if st["trim_end"]:
            rep.write("Trimming %d bases from the end of the reads\n" % st["trim_end"])
            if st["min_len"]:
                rep.write("Discarding reads shorter than %d bases\n" % st["min_len"])
        _shared.in_out_report(rep, n_in, n_out)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

"""fasta_formatter — reflow multi-line FASTA (the only tool that accepts
multi-line input).

Counterpart of ``fastx_toolkit_tpu/cli/tools/fasta_formatter.py``
(FASTX-Toolkit's ``fasta_formatter.cpp`` and ``sequence_writers.h``), byte
for byte, on the host only.  Note this tool has its OWN argument parser
(not fastx_args, fasta_formatter.cpp:96-133): -h exits 0, there is no
-v/-z/-Q, and unknown options exit 1 silently (after getopt's stderr
message).  It reads in blocks of FASTX_TPU_BLOCK_BYTES (64 MiB), as the
reference does.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fasta_formatter \\
        [-h] [-i INFILE] [-o OUTFILE] [-w N] [-t] [-e]
"""

from __future__ import annotations

import sys

from .. import common
from ..common import CliContext, ExitWithStatus

USAGE = (
    "usage: fasta_formatter [-h] [-i INFILE] [-o OUTFILE] [-w N] [-t] [-e]\n"
    "Part of " + common.PACKAGE_STRING + " by assafgordon@gmail.com\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "   [-w N]       = max. sequence line width for output FASTA file.\n"
    "                  When ZERO (the default), sequence lines will NOT be wrapped -\n"
    "                  all nucleotides of each sequences will appear on a single \n"
    "                  line (good for scripting).\n"
    "   [-t]         = Output tabulated format (instead of FASTA format).\n"
    "                  Sequence-Identifiers will be on first column,\n"
    "                  Nucleotides will appear on second column (as single line).\n"
    "   [-e]         = Output empty sequences (default is to discard them).\n"
    "                  Empty sequences are ones who have only a sequence identifier,\n"
    "                  but not actual nucleotides.\n"
    "\n"
    "Input Example:\n"
    "   >MY-ID\n"
    "   AAAAAGGGGG\n"
    "   CCCCCTTTTT\n"
    "   AGCTN\n"
    "\n"
    "Output example with unlimited line width [-w 0]:\n"
    "   >MY-ID\n"
    "   AAAAAGGGGGCCCCCTTTTTAGCTN\n"
    "\n"
    "Output example with max. line width=7 [-w 7]:\n"
    "   >MY-ID\n"
    "   AAAAAGG\n"
    "   GGGTTTT\n"
    "   TCCCCCA\n"
    "   GCTN\n"
    "\n"
    "Output example with tabular output [-t]:\n"
    "   MY-ID	AAAAAGGGGGCCCCCTTTTAGCTN\n"
    "\n"
    "example of empty sequence:\n"
    "(will be discarded unless [-e] is used)\n"
    "  >REGULAR-SEQUENCE-1\n"
    "  AAAGGGTTTCCC\n"
    "  >EMPTY-SEQUENCE\n"
    "  >REGULAR-SEQUENCE-2\n"
    "  AAGTAGTAGTAGTAGT\n"
    "  GTATTTTATAT\n"
    "\n"
    "\n"
)


def _write_seq(out, seq_id: bytes, seq: bytes, *, tabular, width, keep_empty):
    if not keep_empty and not seq:
        return
    if tabular:
        out.append(seq_id[1:] if seq_id.startswith(b">") else seq_id)
        if seq:
            out.append(b"\t")
            out.append(seq)
        out.append(b"\n")
        return
    out.append(seq_id)
    out.append(b"\n")
    if seq:
        if width == 0:
            out.append(seq)
            out.append(b"\n")
        else:
            start = 0
            while len(seq) - start >= width:
                out.append(seq[start : start + width])
                out.append(b"\n")
                start += width
            if len(seq) - start > 0:
                out.append(seq[start:])
                out.append(b"\n")


def tool_main(ctx: CliContext, argv) -> int:
    input_filename = ""
    output_filename = ""
    keep_empty = False
    tabular = False
    width = 0

    for opt, arg in common.getopt_loop(ctx, argv, "i:o:hw:te"):
        if opt == "h":
            ctx.stdout_text.write(USAGE)
            raise ExitWithStatus(0)
        elif opt == "i":
            input_filename = arg
        elif opt == "o":
            output_filename = arg
        elif opt == "w":
            width = common.c_atoi(arg)
            if width < 0:
                print(
                    "%s: Invalid value (%s) for requested width [-w]" % (ctx.prog, arg),
                    file=ctx.stderr,
                )
                raise ExitWithStatus(1)
        elif opt == "t":
            tabular = True
        elif opt == "e":
            keep_empty = True
        else:
            raise ExitWithStatus(1)

    if input_filename in ("", "-"):
        stream = ctx.stdin
    else:
        try:
            stream = open(input_filename, "rb")
        except OSError:
            raise ExitWithStatus(1)

    if output_filename in ("", "-"):
        sink = ctx.stdout
        close_sink = False
    else:
        sink = open(output_filename, "wb")
        close_sink = True

    import os as _os

    block_bytes = int(_os.environ.get("FASTX_TPU_BLOCK_BYTES", 64 * 1024 * 1024))
    seq_id = b""
    seq = b""
    first = True
    carry = b""
    while True:
        block = stream.read(block_bytes)
        data = carry + block if carry else block
        if not block:
            lines = data.split(b"\n")
            carry = b""
        else:
            lines = data.split(b"\n")
            carry = lines.pop()  # last piece may be a partial line
        out: list = []
        for line in lines:
            if not line:
                continue
            if line.startswith(b">"):
                if first:
                    first = False
                else:
                    _write_seq(out, seq_id, seq, tabular=tabular, width=width,
                               keep_empty=keep_empty)
                seq_id = line
                seq = b""
            else:
                seq += line
        sink.write(b"".join(out))
        if not block:
            break
    out = []
    _write_seq(out, seq_id, seq, tabular=tabular, width=width, keep_empty=keep_empty)
    sink.write(b"".join(out))
    if close_sink:
        sink.close()
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

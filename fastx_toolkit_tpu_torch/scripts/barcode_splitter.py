"""fastx_barcode_splitter — demultiplex FASTA/FASTQ by barcode.

Counterpart of ``fastx_toolkit_tpu/scripts/barcode_splitter.py``
(FASTX-Toolkit's ``fastx_barcode_splitter.pl``), byte for byte.  The per-
read x per-barcode XOR-hamming loop (:231-254) becomes one
``[B, n_barcodes]`` mismatch matrix on the device ``FASTX_TORCH_DEVICE``
names (default ``cuda``; ``ops.transforms.barcode_match``, plain torch
ops); record routing and the summary table reproduce the Perl byte for
byte.

Faithful details:
* records are raw line quadruples/pairs written back verbatim (the Perl
  only chomps the bases line and re-adds "\\n", :223,318-325)
* partial barcodes are pre-expanded (trim 5' for --bol, 3' for --eol)
  and penalized by (full_length - len(partial)) ON TOP of the xor
  padding mismatches, exactly like the Perl (:176-181,244-248)
* best barcode = first strict improvement below barcodes_length (:250)
* ties in the summary are sorted by identifier (Perl sort, :284)

Usage:
    python -m fastx_toolkit_tpu_torch.scripts.barcode_splitter \\
        --bcfile FILE --prefix PREFIX [--suffix SUFFIX] --bol|--eol \\
        [--mismatches N] [--exact] [--partial N] [--quiet] < in.fq
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.errors import FastxError
from ..device import resolve_device
from ..engine.pipeline import padded_width
from ..ops import transforms


def _matcher(frag, lens, bc_mat, bc_lens, penalties, *, bol, barcodes_length):
    """``transforms.barcode_match`` on the device ``resolve_device()``
    names: the numpy operands go up, ``(best_index, best_mm)`` come back
    as numpy arrays."""
    dev = resolve_device()
    best_idx, best_mm = transforms.barcode_match(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (frag, lens, bc_mat, bc_lens, penalties)),
        bol=bol, barcodes_length=barcodes_length)
    return best_idx.cpu().numpy(), best_mm.cpu().numpy()

USAGE_TEMPLATE = """Barcode Splitter, by Assaf Gordon (gordon\\@cshl.edu), 11sep2008

This program reads FASTA/FASTQ file and splits it into several smaller files,
Based on barcode matching.
FASTA/FASTQ data is read from STDIN (format is auto-detected.)
Output files will be writen to disk.
Summary will be printed to STDOUT.

usage: {prog} --bcfile FILE --prefix PREFIX [--suffix SUFFIX] [--bol|--eol]
         [--mismatches N] [--exact] [--partial N] [--help] [--quiet] [--debug]

Arguments:

--bcfile FILE	- Barcodes file name. (see explanation below.)
--prefix PREFIX	- File prefix. will be added to the output files. Can be used
		  to specify output directories.
--suffix SUFFIX	- File suffix (optional). Can be used to specify file
		  extensions.
--bol		- Try to match barcodes at the BEGINNING of sequences.
		  (What biologists would call the 5' end, and programmers
		  would call index 0.)
--eol		- Try to match barcodes at the END of sequences.
		  (What biologists would call the 3' end, and programmers
		  would call the end of the string.)
		  NOTE: one of --bol, --eol must be specified, but not both.
--mismatches N	- Max. number of mismatches allowed. default is 1.
--exact		- Same as '--mismatches 0'. If both --exact and --mismatches
		  are specified, '--exact' takes precedence.
--partial N	- Allow partial overlap of barcodes. (see explanation below.)
		  (Default is not partial matching)
--quiet		- Don't print counts and summary at the end of the run.
		  (Default is to print.)
--debug		- Print lots of useless debug information to STDERR.
--help		- This helpful help screen.
"""


class Args:
    bcfile = None
    prefix = None
    suffix = ""
    bol = False
    eol = False
    exact = False
    partial = 0
    mismatches = 1
    quiet = False
    debug = False


def parse_args(argv, stderr) -> Args:
    a = Args()
    if not argv:
        raise _Usage()
    i = 0
    flags = {
        "--bcfile": ("bcfile", True), "--prefix": ("prefix", True),
        "--suffix": ("suffix", True), "--bol": ("bol", False),
        "--eol": ("eol", False), "--exact": ("exact", False),
        "--partial": ("partial", True), "--mismatches": ("mismatches", True),
        "--quiet": ("quiet", False), "--debug": ("debug", False),
        "--help": ("help", False),
    }
    while i < len(argv):
        tok = argv[i]
        name, val = tok, None
        if "=" in tok:
            name, val = tok.split("=", 1)
        # GetOptions allows unambiguous prefixes; support exact names only
        if name not in flags:
            print("Unknown option: %s" % tok.lstrip("-"), file=stderr)
            raise SystemExit(1)
        attr, takes = flags[name]
        if attr == "help":
            raise _Usage()
        if takes:
            if val is None:
                i += 1
                if i >= len(argv):
                    print("Option %s requires an argument" % name, file=stderr)
                    raise SystemExit(1)
                val = argv[i]
            if attr in ("partial", "mismatches"):
                val = int(val)
            setattr(a, attr, val)
        else:
            setattr(a, attr, True)
        i += 1

    if a.bcfile is None:
        raise FastxError("Error: barcode file not specified (use '--bcfile [FILENAME]')\n", 255)
    if a.prefix is None:
        raise FastxError("Error: prefix path/filename not specified (use '--prefix [PATH]')\n", 255)
    if a.bol == a.eol:
        if a.eol:
            raise FastxError("Error: can't specify both --eol & --bol\n", 255)
        raise FastxError("Error: must specify either --eol or --bol\n", 255)
    if a.partial < 0:
        raise FastxError("Error: invalid for value partial matches (valid values are 0 or greater)\n", 255)
    if a.exact:
        a.mismatches = 0
    if a.mismatches < 0:
        raise FastxError("Error: invalid value for mismatches (valid values are 0 or more)\n", 255)
    if a.partial > a.mismatches:
        raise FastxError(
            "Error: partial overlap value (%d) bigger than max. allowed mismatches (%d)\n"
            % (a.partial, a.mismatches), 255,
        )
    return a


class _Usage(Exception):
    pass


def load_barcode_file(a: Args):
    """fastx_barcode_splitter.pl:147-192 (including the partial-variant
    pre-expansion)."""
    import re

    try:
        raw = open(a.bcfile, "rb").read()
    except OSError:
        raise FastxError("Error: failed to open barcode file (%s)\n" % a.bcfile, 255)
    barcodes = []  # list of (ident, barcode bytes)
    barcodes_length = None
    # Perl reads \n-terminated lines; a trailing newline does not create a
    # final empty line, but a file NOT ending in \n still yields its last
    # partial line (fastx_barcode_splitter.pl:151 while(<BCFILE>))
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":  # trailing \n (or empty file) adds no line
        lines.pop()
    for lineno, line in enumerate(lines, 1):
        if line.startswith(b"#"):
            continue
        fields = line.split()
        # Perl: ($ident, $barcode) = split; $barcode = uc($barcode) turns
        # an undef barcode (blank or one-field line) into "" — which is
        # *defined*, so the 'bad data' die at :158 is dead code and the
        # failure surfaces as 'bad barcode value ()' at :159
        ident = fields[0].decode("latin-1") if fields else ""
        barcode = fields[1].upper() if len(fields) > 1 else b""
        if not re.fullmatch(rb"[AGCT]+", barcode):
            raise FastxError(
                "Error: bad barcode value (%s) at barcode file (%s) line %d\n"
                % (barcode.decode("latin-1"), a.bcfile, lineno), 255,
            )
        if not re.fullmatch(r"\w+", ident):
            raise FastxError(
                "Error: bad identifier value (%s) at barcode file (%s) line %d (must be alphanumeric)\n"
                % (ident, a.bcfile, lineno), 255,
            )
        if len(barcode) <= a.mismatches:
            raise FastxError(
                "Error: badcode(%s, %s) is shorter or equal to maximum number of "
                "mismatches (%d). This makes no sense. Specify fewer  mismatches.\n"
                % (ident, barcode.decode("latin-1"), a.mismatches), 255,
            )
        if barcodes_length is None:
            barcodes_length = len(barcode)
        elif barcodes_length != len(barcode):
            raise FastxError(
                "Error: found barcodes in different lengths. this feature is not supported yet.\n",
                255,
            )
        barcodes.append((ident, barcode))
        if a.partial > 0:
            b = barcode
            for _ in range(a.partial):
                b = b[1:] if a.bol else b[:-1]
                barcodes.append((ident, b))
    # An empty (or all-comment) barcode file is NOT an error in the Perl:
    # @barcodes stays empty, every read routes to 'unmatched'
    # (fastx_barcode_splitter.pl:227-257 with an empty foreach).
    return barcodes, barcodes_length


def split_records(data: bytes, fastq: bool):
    """Frame raw records as byte spans: list of (start, end) covering the
    record's full lines, plus the chomped bases-line span."""
    n = len(data)
    line_starts = [0]
    pos = data.find(b"\n")
    while pos != -1:
        line_starts.append(pos + 1)
        pos = data.find(b"\n", pos + 1)
    if line_starts[-1] == n:
        line_starts.pop()
    nlines = len(line_starts)

    def line_end(i):
        if i + 1 < nlines:
            return line_starts[i + 1] - 1
        # final line of the file: chomp the trailing newline if present
        # (the Perl's chomp, fastx_barcode_splitter.pl:223)
        return n - 1 if data.endswith(b"\n") else n

    lpr = 4 if fastq else 2
    recs = []
    i = 0
    while i < nlines:
        if i + 1 >= nlines:
            raise FastxError("Error: bad input file, expecting line with sequences\n", 255)
        if fastq and i + 3 >= nlines:
            missing = nlines - i
            if missing == 2:
                raise FastxError("Error: bad input file, expecting line with sequence name2\n", 255)
            raise FastxError("Error: bad input file, expecting line with quality scores\n", 255)
        rec_start = line_starts[i]
        bases_start = line_starts[i + 1]
        bases_end = line_end(i + 1)  # chomped (w/o trailing \n)
        last = i + lpr - 1
        rec_end = line_starts[last + 1] if last + 1 < nlines else n
        recs.append((rec_start, rec_end, bases_start, bases_end))
        i += lpr
    return recs


def main_io(argv, stdin, stdout, stderr, prog="fastx_barcode_splitter.pl") -> int:
    try:
        a = parse_args(argv, stderr)
    except _Usage:
        stdout.write(USAGE_TEMPLATE.replace("\\@", "@").format(prog=prog))
        return 1

    barcodes, barcodes_length = load_barcode_file(a)

    data = stdin.read()
    if not data:
        raise FastxError(
            "Error: unknown file format. First character = '' (expecting > or @)\n", 255
        )
    first = data[:1]
    if first == b">":
        fastq = False
    elif first == b"@":
        fastq = True
    else:
        raise FastxError(
            "Error: unknown file format. First character = '%s' (expecting > or @)\n"
            % first.decode("latin-1"), 255,
        )

    recs = split_records(data, fastq)
    B = len(recs)
    buf = np.frombuffer(data, np.uint8)

    if barcodes_length is None:
        # zero barcodes: the Perl's matcher loop is empty, best ident
        # stays undef and every record is 'unmatched'
        barcodes_length = 0
        matched = np.zeros(B, bool)
        best_idx = np.full(B, -1, np.int64)
        idents = np.array([], dtype=object)
        return _route_and_report(a, data, recs, fastq, matched, best_idx,
                                 idents, [], stdout)

    # build [B, max(barcodes_length, pad)] fragment-source matrix: the
    # chomped bases line bytes, the width padded as the reference pads it
    # (B stays as read: an eager matcher has no compiled shape to reuse)
    b_starts = np.array([r[2] for r in recs], np.int64)
    b_lens = np.array([r[3] - r[2] for r in recs], np.int64)
    L = padded_width(max(int(b_lens.max()) if B else 0, barcodes_length))
    col = np.arange(L, dtype=np.int64)
    mask = col[None, :] < b_lens[:, None]
    frag = np.zeros((B, L), np.uint8)
    idx2 = b_starts[:, None] + col[None, :]
    frag[mask] = buf[np.minimum(idx2, len(buf) - 1)[mask]]

    K = len(barcodes)
    bc_mat = np.zeros((K, barcodes_length), np.uint8)
    bc_lens = np.zeros(K, np.int32)
    for k, (_, b) in enumerate(barcodes):
        bc_mat[k, : len(b)] = np.frombuffer(b, np.uint8)
        bc_lens[k] = len(b)
    penalties = barcodes_length - bc_lens

    best_idx, best_mm = (
        np.asarray(x)[:B]
        for x in _matcher(
            frag, b_lens.astype(np.int32), bc_mat, bc_lens, penalties,
            bol=a.bol, barcodes_length=barcodes_length,
        )
    )
    idents = np.array([ident for ident, _ in barcodes])
    matched = (best_idx >= 0) & (best_mm <= a.mismatches)
    return _route_and_report(a, data, recs, fastq, matched, best_idx,
                             idents, barcodes, stdout)


def _route_and_report(a, data, recs, fastq, matched, best_idx, idents,
                      barcodes, stdout) -> int:
    # unique identifier set, a file per identifier + 'unmatched'
    uniq = []
    seen = set()
    for ident, _ in barcodes:
        if ident not in seen:
            seen.add(ident)
            uniq.append(ident)
    all_idents = uniq + (["unmatched"] if "unmatched" not in seen else [])

    filenames = {ident: a.prefix + ident + a.suffix for ident in all_idents}
    counts = {ident: 0 for ident in all_idents}

    # route records
    chosen = np.where(matched, best_idx, -1)
    payloads = {ident: [] for ident in all_idents}
    for i, (rs, re_, bs, be) in enumerate(recs):
        k = int(chosen[i])
        ident = idents[k] if k >= 0 else "unmatched"
        counts[ident] += 1
        # name line + chomped bases + "\n" + rest
        payloads[ident].append(data[rs:bs] + data[bs:be] + b"\n")
        if fastq:
            nl = data.find(b"\n", be)
            rest_start = (nl + 1) if nl != -1 else re_
            payloads[ident].append(data[rest_start:re_])

    for ident in all_idents:
        try:
            with open(filenames[ident], "wb") as f:
                f.write(b"".join(payloads[ident]))
        except OSError:
            raise FastxError(
                "Error: failed to create output file (%s)\n" % filenames[ident], 255
            )

    if not a.quiet:
        stdout.write("Barcode\tCount\tLocation\n")
        total = 0
        for ident in sorted(counts):
            stdout.write("%s\t%d\t%s\n" % (ident, counts[ident], filenames[ident]))
            total += counts[ident]
        stdout.write("total\t%d\n" % total)
    return 0


def main():
    try:
        status = main_io(sys.argv[1:], sys.stdin.buffer, sys.stdout, sys.stderr)
    except FastxError as e:
        sys.stderr.write(str(e))
        status = e.status
    sys.exit(status)


if __name__ == "__main__":
    main()

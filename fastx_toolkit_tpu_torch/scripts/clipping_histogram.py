"""fasta_clipping_histogram — sequence-length histogram image.

Counterpart of ``fastx_toolkit_tpu/scripts/clipping_histogram.py``
(FASTX-Toolkit's ``fasta_clipping_histogram.pl``: GD::Graph bars of the
length distribution weighted by collapsed counts parsed from '>id-count'
headers, gzip input supported).  matplotlib's Agg backend instead of
GD::Graph.  Runs on the host only.

Usage:
    python -m fastx_toolkit_tpu_torch.scripts.clipping_histogram \\
        INPUT_FILE.FA OUTPUT_FILE.PNG
"""

from __future__ import annotations

import gzip
import re
import sys

USAGE = """
Create a Linker Clipping Information Histogram

usage: {prog} INPUT_FILE.FA OUTPUT_FILE.PNG

	INPUT_FILE.FA   = input file (in FASTA format, can be GZIPped)
	OUTPUT_FILE.PNG = histogram image

"""

_COUNT_RE = re.compile(rb"^\>[^-]+\-(\d+)$")


def build_histogram(stream) -> dict:
    hist: dict[int, int] = {}
    while True:
        name = stream.readline()
        if not name:
            break
        seq = stream.readline()
        seq = seq.rstrip(b"\n")
        n = len(seq)
        name_c = name.rstrip(b"\n")
        if b"-" not in name_c:
            count = 1
        else:
            m = _COUNT_RE.match(name_c)
            count = int(m.group(1)) if m else 1
        hist[n] = hist.get(n, 0) + count
    return hist


def main_io(argv, prog="fasta_clipping_histogram.pl") -> int:
    if not argv:
        sys.stdout.write(USAGE.format(prog=prog))
        return 0
    infile, outfile = argv[0], argv[1]
    try:
        raw = open(infile, "rb")
        head = raw.read(2)
        raw.seek(0)
        stream = gzip.open(raw) if head == b"\x1f\x8b" else raw
    except OSError:
        print("Cannot open input file %s" % infile, file=sys.stderr)
        return 1

    hist = build_histogram(stream)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = sorted(hist)
    vals = [hist[k] for k in keys]
    fig, ax = plt.subplots(figsize=(1000 / 100, 800 / 100), dpi=100)
    ax.bar(range(len(keys)), vals, width=0.6, color="#4d89f9", edgecolor="black")
    ax.set_xticks(range(len(keys)))
    ax.set_xticklabels([str(k) for k in keys])
    ax.set_xlabel("Length")
    ax.set_ylabel("Amount")
    ax.set_title("Sequences lengths Distribution (after clipping)")
    ax.grid(axis="y", linestyle="-", linewidth=0.3)
    try:
        with open(outfile, "wb") as f:
            fig.savefig(f, format="png")
    except OSError:
        print("Cannot create output file %s" % outfile, file=sys.stderr)
        return 1
    plt.close(fig)
    return 0


def main():
    sys.exit(main_io(sys.argv[1:]))


if __name__ == "__main__":
    main()

"""fastx_nucleotide_distribution_graph — per-cycle base composition chart.

Counterpart of ``fastx_toolkit_tpu/scripts/nucleotide_distribution.py``
(FASTX-Toolkit's ``fastx_nucleotide_distribution_graph.sh``: a stacked
histogram of A/C/G/T/N percentages from old-format stats columns 13..17,
normalized by column 18; and ``fastx_nucleotide_distribution_line_graph.sh``,
the line plot variant reading the NEW -N stats format, :func:`main_line`).
matplotlib's Agg backend instead of gnuplot; same input validation
messages as the boxplot script.  Runs on the host only.

Usage:
    python -m fastx_toolkit_tpu_torch.scripts.nucleotide_distribution \\
        -i STATS.TXT [-t TITLE] [-p] [-o OUTPUT]
"""

from __future__ import annotations

import sys

from .quality_boxplot import (
    FASTA_MSG,
    FASTQ_MSG,
    INVALID_MSG,
    check_stats_header,
    detect_fastx,
    parse_args,
)

USAGE = """FASTX Nucleotide Distribution Plotter

Usage: {prog} [-i INPUT.TXT] [-t TITLE] [-p] [-o OUTPUT]

  [-p]           - Generate PostScript (.PS) file. Default is PNG image.
  [-i INPUT.TXT] - Input file. Should be the output of "fastx_quality_statistics" program.
  [-o OUTPUT]    - Output file name. default is STDOUT.
  [-t TITLE]     - Title - will be plotted on the graph.

"""

COLORS = {"A": "#00ee00", "C": "#0000ee", "G": "#888888", "T": "#ee0000", "N": "#ffffff"}


def _load(filename, *, new_format: bool):
    with open(filename) as f:
        lines = f.read().splitlines()
    kind = detect_fastx(lines)
    if kind == "FASTA":
        sys.stderr.write(FASTA_MSG)
        raise SystemExit(1)
    if kind == "FASTQ":
        sys.stderr.write(FASTQ_MSG)
        raise SystemExit(1)
    wanted = ("cycle", "max_count", "ALL_count") if new_format else ("column", "count", "min")
    if new_format:
        ok = bool(lines) and lines[0].split("\t")[:2] == ["cycle", "max_count"]
    else:
        ok = check_stats_header(lines)
    if not ok:
        sys.stderr.write(INVALID_MSG)
        raise SystemExit(1)
    return lines


def _percent_rows(lines, *, new_format: bool):
    cycles, pct = [], {b: [] for b in "ACGTN"}
    for line in lines[1:]:
        f = line.split("\t")
        if len(f) < 18:
            continue
        cycles.append(int(f[0]))
        if new_format:
            # new format: ALL block cols 2..12, then A/C/G/T/N blocks of 11
            total = float(f[1])
            counts = {b: float(f[2 + 11 * (i + 1)]) for i, b in enumerate("ACGTN")}
        else:
            total = float(f[17])
            counts = dict(zip("ACGTN", (float(x) for x in f[12:17])))
        for b in "ACGTN":
            pct[b].append(100.0 * counts[b] / total if total else 0.0)
    return cycles, pct


def _render(cycles, pct, title, outputfile, postscript, *, stacked: bool):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(1024 / 100, 768 / 100), dpi=100)
    if stacked:
        bottom = np.zeros(len(cycles))
        for b in "ACGTN":
            vals = np.array(pct[b])
            ax.bar(cycles, vals, bottom=bottom, width=0.8, label=b,
                   color=COLORS[b], edgecolor="black", linewidth=0.3)
            bottom += vals
        ax.set_ylim(0, 100)
    else:
        for b in "ACGTN":
            ax.plot(cycles, pct[b], label=b,
                    color=COLORS[b] if b != "N" else "#bbbbbb", linewidth=1.5)
        ax.set_ylim(0, 100)
    ax.set_xlabel("read position")
    ax.set_ylabel("% of total (per read position)")
    ax.set_title("Nucleotides distribution %s" % title)
    ax.legend(loc="upper right", title="nucleotides")
    fmt = "ps" if postscript else "png"
    if outputfile in ("/dev/stdout", "-"):
        fig.savefig(sys.stdout.buffer, format=fmt)
    else:
        fig.savefig(outputfile, format=fmt)
    plt.close(fig)


def main_io(argv, *, line_graph: bool, prog) -> int:
    title, filename, outputfile, postscript = parse_args(argv, prog)
    if not filename:
        sys.stdout.write(USAGE.format(prog=prog))
        raise SystemExit(0)
    lines = _load(filename, new_format=line_graph)
    cycles, pct = _percent_rows(lines, new_format=line_graph)
    _render(cycles, pct, title, outputfile, postscript, stacked=not line_graph)
    return 0


def main():
    sys.exit(main_io(sys.argv[1:], line_graph=False,
                     prog="fastx_nucleotide_distribution_graph.sh"))


def main_line():
    sys.exit(main_io(sys.argv[1:], line_graph=True,
                     prog="fastx_nucleotide_distribution_line_graph.sh"))


if __name__ == "__main__":
    main()

"""fastq_quality_boxplot_graph — boxplot from fastx_quality_stats output.

Counterpart of ``fastx_toolkit_tpu/scripts/quality_boxplot.py``
(FASTX-Toolkit's ``fastq_quality_boxplot_graph.sh``: gnuplot candlesticks
from old-format stats columns 1,7,11,12,9,8).  Rendered with matplotlib's
Agg backend, imported only when a plot is drawn, instead of gnuplot; the
input validation (friendly errors when handed raw FASTA/FASTQ or a
non-stats file) reproduces the shell script's awk checks and messages.
Runs on the host only.

Usage:
    python -m fastx_toolkit_tpu_torch.scripts.quality_boxplot \\
        -i STATS.TXT [-t TITLE] [-p] [-o OUTPUT]
"""

from __future__ import annotations

import re
import sys

USAGE = """Solexa-Quality BoxPlot plotter
Generates a solexa quality score box-plot graph

Usage: {prog} [-i INPUT.TXT] [-t TITLE] [-p] [-o OUTPUT]

  [-p]           - Generate PostScript (.PS) file. Default is PNG image.
  [-i INPUT.TXT] - Input file. Should be the output of \"solexa_quality_statistics\" program.
  [-o OUTPUT]    - Output file name. default is STDOUT.
  [-t TITLE]     - Title (usually the solexa file name) - will be plotted on the graph.

"""

FASTA_MSG = """Error: It looks like your input file is a FASTA file.

FASTA files do not contain quality scores, and can not be used with this tool.
"""

FASTQ_MSG = """Error: It looks like your input file is a FASTQ file.

This tool (fastq-quality-plot) can't use FASTQ files directly - it requires a tabular text file conaining summary statistic about your FASTQ file.

In Galaxy,
Please use the "Compute Quality Statistics" tool (in the "NGS: QC and Manipulation" category) to compute the quality statistics report, and then use this tool with the new statistics report.

On the command line,
Please use the "fastx_quality_stats" program to create the statistics report.
"""

INVALID_MSG = """Error: Input file is not a valid statistics report.

This tool (fastq-quality-plot) requires a tabular text file conaining summary statistic about your FASTQ file.

In Galaxy,
Please use the "Compute Quality Statistics" tool (in the "NGS: QC and Manipulation" category) to compute the quality statistics report, and then use this tool with the new statistics report.

On the command line,
Please use the "fastx_quality_stats" program to create the statistics report.
"""


def detect_fastx(lines) -> str:
    """The shell's AWK_FASTX_DETECTION (fastq_quality_boxplot_graph.sh:76-83)."""
    fasta_id = fastq_id = nucleotides = False
    for i, line in enumerate(lines[:3]):
        if i == 0 and line.startswith(">"):
            fasta_id = True
        if i == 0 and line.startswith("@"):
            fastq_id = True
        if i == 1 and re.fullmatch(r"[ACGT][ACGT]*", line):
            nucleotides = True
    if fasta_id and nucleotides:
        return "FASTA"
    if fastq_id and nucleotides:
        return "FASTQ"
    return ""


def check_stats_header(lines, wanted=("column", "count", "min")) -> bool:
    if not lines:
        return False
    f = lines[0].split()
    return len(f) >= 3 and tuple(f[:3]) == wanted


def parse_args(argv, prog):
    title = ""
    filename = ""
    outputfile = "/dev/stdout"
    postscript = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-t":
            i += 1
            title = "for " + argv[i]
        elif a == "-i":
            i += 1
            filename = argv[i]
        elif a == "-o":
            i += 1
            outputfile = argv[i]
        elif a == "-p":
            postscript = True
        elif a == "-h":
            sys.stdout.write(USAGE.format(prog=prog))
            raise SystemExit(0)
        else:
            print("unrecognized argument. use '-h' for usage information.")
            raise SystemExit(255)
        i += 1
    return title, filename, outputfile, postscript


def main_io(argv, prog="fastq_quality_boxplot_graph.sh") -> int:
    title, filename, outputfile, postscript = parse_args(argv, prog)
    if not filename:
        sys.stdout.write(USAGE.format(prog=prog))
        raise SystemExit(0)
    try:
        with open(filename) as f:
            lines = f.read().splitlines()
    except OSError:
        print("Error: can't open input file (%s)." % filename, file=sys.stderr)
        return 1

    kind = detect_fastx(lines)
    if kind == "FASTA":
        sys.stderr.write(FASTA_MSG)
        return 1
    if kind == "FASTQ":
        sys.stderr.write(FASTQ_MSG)
        return 1
    if not check_stats_header(lines):
        sys.stderr.write(INVALID_MSG)
        return 1

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cyc, q1, lw, rw, q3, med = [], [], [], [], [], []
    for line in lines[1:]:
        f = line.split("\t")
        if len(f) < 12:
            continue
        cyc.append(int(f[0]))
        q1.append(int(f[6]))
        med.append(int(f[7]))
        q3.append(int(f[8]))
        lw.append(int(f[10]))
        rw.append(int(f[11]))

    n = len(cyc)
    fig, ax = plt.subplots(figsize=(2048 / 100, 768 / 100), dpi=100)
    for i in range(n):
        x = cyc[i]
        ax.add_patch(
            plt.Rectangle((x - 0.4, q1[i]), 0.8, max(q3[i] - q1[i], 0),
                          fill=False, edgecolor="red", linewidth=1)
        )
        ax.plot([x, x], [lw[i], q1[i]], color="red", linewidth=1)
        ax.plot([x, x], [q3[i], rw[i]], color="red", linewidth=1)
        ax.plot([x - 0.3, x + 0.3], [lw[i], lw[i]], color="red", linewidth=1)
        ax.plot([x - 0.3, x + 0.3], [rw[i], rw[i]], color="red", linewidth=1)
        ax.plot([x - 0.4, x + 0.4], [med[i], med[i]], color="black", linewidth=2)
    ax.set_xlim(0, n + 1)
    ax.set_ylim(-15, 45)
    ax.set_xlabel("read position")
    ax.set_ylabel("Quality Score (Solexa Scale: 40=Highest, -15=Lowest)")
    ax.set_title("Quality Scores %s" % title)
    ax.grid(axis="y", linestyle=":", linewidth=0.5)
    fmt = "ps" if postscript else "png"
    if outputfile in ("/dev/stdout", "-"):
        fig.savefig(sys.stdout.buffer, format=fmt)
    else:
        fig.savefig(outputfile, format=fmt)
    plt.close(fig)
    return 0


def main():
    sys.exit(main_io(sys.argv[1:]))


if __name__ == "__main__":
    main()

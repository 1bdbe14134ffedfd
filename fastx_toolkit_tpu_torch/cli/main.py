"""``fastx-torch`` dispatcher: one command for every tool the port has.

Counterpart of ``fastx_toolkit_tpu/cli/main.py`` (``fastx-tpu``), with the
same 21 tools, the same module layout (``cli.tools`` and ``scripts``),
the ``.pl``/``.sh`` suffixes stripped and the
``fastx_nucleotide_distribution_line_graph`` alias, which runs the
nucleotide-distribution script's line graph; any other name is the
reference's "unknown tool" error, exit 1.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.main TOOL [ARGS...]
    fastx-torch TOOL [ARGS...]      (the pyproject script)
"""

from __future__ import annotations

import importlib
import sys

_TOOLS = "fastx_toolkit_tpu_torch.cli.tools."
_SCRIPTS = "fastx_toolkit_tpu_torch.scripts."
TOOLS = {name: _TOOLS + name for name in (
    "fastq_to_fasta",
    "fastq_quality_converter",
    "fastq_quality_filter",
    "fastq_quality_trimmer",
    "fastq_masker",
    "fastx_trimmer",
    "fastx_clipper",
    "fastx_artifacts_filter",
    "fastx_reverse_complement",
    "fastx_collapser",
    "fastx_uncollapser",
    "fastx_renamer",
    "fasta_nucleotide_changer",
    "fasta_formatter",
    "fastx_quality_stats",
    "fastx_pipeline",
    "seqalign_test",
)}
TOOLS.update({
    "fastx_barcode_splitter": _SCRIPTS + "barcode_splitter",
    "fastq_quality_boxplot_graph": _SCRIPTS + "quality_boxplot",
    "fastx_nucleotide_distribution_graph": _SCRIPTS + "nucleotide_distribution",
    "fasta_clipping_histogram": _SCRIPTS + "clipping_histogram",
})
LINE_GRAPH = "fastx_nucleotide_distribution_line_graph"


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: fastx-torch TOOL [ARGS...]\n\ntools:")
        for t in sorted(TOOLS):
            print("  " + t)
        sys.exit(0 if len(sys.argv) >= 2 else 1)
    tool = sys.argv[1]
    name = tool.removesuffix(".pl").removesuffix(".sh")
    if name == LINE_GRAPH:
        mod = importlib.import_module(
            TOOLS["fastx_nucleotide_distribution_graph"])
        sys.argv = [tool] + sys.argv[2:]
        mod.main_line()
        return
    if name not in TOOLS:
        print("fastx-torch: unknown tool '%s'" % tool, file=sys.stderr)
        sys.exit(1)
    mod = importlib.import_module(TOOLS[name])
    sys.argv = [tool] + sys.argv[2:]
    mod.main()


if __name__ == "__main__":
    main()

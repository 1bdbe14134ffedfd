"""``fastx-torch`` dispatcher: one command for every tool the port has.

Counterpart of ``fastx_toolkit_tpu/cli/main.py`` (``fastx-tpu``), listing
the port's tools; any other name is the reference's "unknown tool" error,
exit 1.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.main TOOL [ARGS...]
    fastx-torch TOOL [ARGS...]      (the pyproject script)
"""

from __future__ import annotations

import importlib
import sys

_TOOLS = "fastx_toolkit_tpu_torch.cli.tools."
TOOLS = {name: _TOOLS + name for name in (
    "fastq_to_fasta",
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
    "fastx_quality_stats",
    "fastx_pipeline",
)}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: fastx-torch TOOL [ARGS...]\n\ntools:")
        for t in sorted(TOOLS):
            print("  " + t)
        sys.exit(0 if len(sys.argv) >= 2 else 1)
    tool = sys.argv[1]
    name = tool.removesuffix(".pl").removesuffix(".sh")
    if name not in TOOLS:
        print("fastx-torch: unknown tool '%s'" % tool, file=sys.stderr)
        sys.exit(1)
    mod = importlib.import_module(TOOLS[name])
    sys.argv = [tool] + sys.argv[2:]
    mod.main()


if __name__ == "__main__":
    main()

"""seqalign_test — manual smoke test of the alignment engine.

Counterpart of ``fastx_toolkit_tpu/cli/tools/seqalign_test.py``
(FASTX-Toolkit's ``seqalign_test.cpp``): aligns two fixed strings and
prints the DP matrix and the results (``kernels/align.format_matrix``,
``format_results``), byte for byte.  Runs on the host only.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.seqalign_test
"""

from __future__ import annotations

import sys

from ...kernels import align
from ..common import CliContext
from .. import common


def tool_main(ctx: CliContext, argv) -> int:
    query, target = b"AAAGGTTTCCC", b"AGGCTT"
    ctx.stdout_text.write(align.format_matrix(query, target))
    ctx.stdout_text.write(align.format_results(query, target))
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

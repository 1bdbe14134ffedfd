"""fastx_quality_stats — per-cycle quality/nucleotide statistics.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_quality_stats.py``
(FASTX-Toolkit's ``fastx_quality_stats.c``), byte for byte in the old and
the ``-N`` format.  Two engines give identical accumulators
(``ops/stats.stats_path``; ``FASTX_STATS_PATH=host|device`` overrides):

* ``host``   — the raw-line fast path (``codec.frame_fastq_fast``,
  ``native.validate_records``, ``native.stats_lines_q``), or the parsed
  batch through ``ops/stats.host_accumulate``;
* ``device`` — each parsed batch moves to the device
  ``FASTX_TORCH_DEVICE`` names (default ``cuda``): a FASTQ batch whose
  reads are pure ACGT travels 2-bit packed to the histogram kernel's
  2-bit entry K5b (``csrc/stats_hist.cu``, :func:`b2_inputs`), any other
  batch goes through ``ops/stats.accumulate_dispatch``: for FASTQ the
  histogram kernel K5, for FASTA the plain scatter reduction.

Report rendering is host-side with the reference's exact integer
semantics.  In a process group (``parallel/multihost``) each process
accumulates its own byte range of the input; the accumulators merge with
+/min/max (``multihost.merge_stats_accumulators``) and only process 0
writes the table, on either engine.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_quality_stats \\
        [-h] [-N] [-Q 33|64] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ...core import codec, native
from ...device import resolve_device
from ...engine.pipeline import PipelineConfig, pack_batch2, scan_alphabet
from ...kernels.stats_cuda import stats_hist_b2
from ...ops import stats as stats_ops
from ...parallel import multihost
from .. import common
from ..common import CliContext
from . import _shared

USAGE = (
    "usage: fastx_quality_stats [-h] [-N] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h] = This helpful help screen.\n"
    "   [-i INFILE]  = FASTQ input file. default is STDIN.\n"
    "   [-o OUTFILE] = TEXT output file. default is STDOUT.\n"
    "   [-N]         = New output format (with more information per nucleotide/cycle).\n"
    "\n"
    "The *OLD* output TEXT file will have the following fields (one row per column):\n"
    "	column	= column number (1 to 36 for a 36-cycles read solexa file)\n"
    "	count   = number of bases found in this column.\n"
    "	min     = Lowest quality score value found in this column.\n"
    "	max     = Highest quality score value found in this column.\n"
    "	sum     = Sum of quality score values for this column.\n"
    "	mean    = Mean quality score value for this column.\n"
    "	Q1	= 1st quartile quality score.\n"
    "	med	= Median quality score.\n"
    "	Q3	= 3rd quartile quality score.\n"
    "	IQR	= Inter-Quartile range (Q3-Q1).\n"
    "	lW	= 'Left-Whisker' value (for boxplotting).\n"
    "	rW	= 'Right-Whisker' value (for boxplotting).\n"
    "	A_Count	= Count of 'A' nucleotides found in this column.\n"
    "	C_Count	= Count of 'C' nucleotides found in this column.\n"
    "	G_Count	= Count of 'G' nucleotides found in this column.\n"
    "	T_Count	= Count of 'T' nucleotides found in this column.\n"
    "	N_Count = Count of 'N' nucleotides found in this column.\n"
    "	max-count = max. number of bases (in all cycles)\n"
    "\n"
    "\n"
    "The *NEW* output format:\n"
    "	cycle (previously called 'column') = cycle number\n"
    "	max-count\n"
    "	For each nucleotide in the cycle (ALL/A/C/G/T/N):\n"
    "		count   = number of bases found in this column.\n"
    "		min     = Lowest quality score value found in this column.\n"
    "		max     = Highest quality score value found in this column.\n"
    "		sum     = Sum of quality score values for this column.\n"
    "		mean    = Mean quality score value for this column.\n"
    "		Q1	= 1st quartile quality score.\n"
    "		med	= Median quality score.\n"
    "		Q3	= 3rd quartile quality score.\n"
    "		IQR	= Inter-Quartile range (Q3-Q1).\n"
    "		lW	= 'Left-Whisker' value (for boxplotting).\n"
    "		rW	= 'Right-Whisker' value (for boxplotting).\n"
    "\n"
    "\n"
)


# pack_batch2 with no quality planes: the 2-bit codes alone
_CODES_ONLY = PipelineConfig(with_filter=False, with_qtrim=False,
                             with_mask=False)


def b2_inputs(bases, quals, lengths, device):
    """K5b's inputs for a batch of pure-ACGT reads: the bases 2-bit packed
    (``pack_batch2``, no planes), the quality values and the lengths, as
    tensors on ``device``; None when any base is outside ACGT."""
    bases = np.ascontiguousarray(bases, np.uint8)
    pure, has_n = scan_alphabet(bases)
    if not pure or has_n:
        return None
    quals = np.ascontiguousarray(quals, np.int8)
    b2, _ = pack_batch2(bases, quals, _CODES_ONLY, n_plane=False)
    return tuple(torch.from_numpy(a).to(device) for a in (
        b2, quals, np.ascontiguousarray(lengths, np.int32)))


def _device_parts(batch, device):
    """The device engine's partials of one parsed batch: K5b for FASTQ
    reads of pure ACGT (:func:`b2_inputs`), else
    ``ops/stats.accumulate_dispatch`` (K5 for FASTQ)."""
    xs = (b2_inputs(batch.bases, batch.quals, batch.lengths, device)
          if batch.is_fastq else None)
    if xs is not None:
        return stats_ops.derive_from_hist(stats_hist_b2(*xs))
    bases, quals, lengths, counts = _shared.device_batch(batch, device)
    return stats_ops.accumulate_dispatch(bases, quals, lengths, counts,
                                         is_fastq=batch.is_fastq)


def tool_main(ctx: CliContext, argv) -> int:
    st = {"new_format": False}

    def cb(args, opt, arg):
        if opt == "N":
            st["new_format"] = True

    args = common.parse_cmdline(ctx, argv, "N", cb, USAGE)
    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    acc = stats_ops.StatsAccumulator.empty(0)
    path = stats_ops.stats_path()
    allowed = codec.allowed_table_u8() if path == "host" else None
    device = resolve_device()
    for chunk, line_base in reader.iter_chunks():
        parts = None
        if (path == "host" and reader.is_fastq
                and not os.environ.get("FASTX_TPU_NO_LINEPATH")):
            # fused raw-line fast path: frame + validate + accumulate with
            # no padded-matrix build; any anomaly (numeric quals, framing
            # or byte errors) re-parses for the reference's exact errors.
            # FASTQ multiplicity is always 1 (fastx.c:479-481), so the
            # full stats table derives from this histogram exactly.
            fr = codec.frame_fastq_fast(chunk)
            if fr is not None:
                buf, ss, sl, qs = fr
                if native.validate_records(
                    buf, ss, sl, qs, allowed, args.q_offset
                ) == -1:
                    width = int(sl.max()) if len(sl) else 0
                    pernuc = native.stats_lines_q(
                        buf, ss, qs, sl, width, args.q_offset
                    )
                    parts = stats_ops.derive_from_hist(pernuc)
        if parts is None:
            batch = reader.parse_chunk(chunk, line_base)
            use_host = path == "host" and (
                not batch.is_fastq
                or bool((np.asarray(batch.counts) == 1).all())
            )
            if use_host:
                parts = stats_ops.host_accumulate(
                    batch.bases, batch.quals, batch.lengths, batch.counts,
                    is_fastq=batch.is_fastq,
                )
            else:
                parts = _device_parts(batch, device)
        acc.merge_partial(*parts)

    # every process accumulated its own input shard; the histograms merge
    # with +/min/max across the process group and only process 0 renders
    # (byte-identical to a single-process run)
    acc = multihost.merge_stats_accumulators(acc)
    text = (
        stats_ops.render_new_format(acc)
        if st["new_format"]
        else stats_ops.render_old_format(acc)
    )
    # the reference writes stats through plain fopen — -z is accepted but
    # never compresses here (fastx_quality_stats.c:443-448)
    writer = common.OutputWriter(
        ctx, dataclasses.replace(args, compress=False), role="merged")
    writer.write(text.encode())
    writer.close()
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

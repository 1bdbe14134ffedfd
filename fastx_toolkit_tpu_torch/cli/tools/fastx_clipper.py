"""fastx_clipper — adapter clipping via the batched half-local DP on the
card.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_clipper.py`` (FASTX-
Toolkit's ``fastx_clipper.cpp``): every flag, the legacy stale-matrix
emulation with its carry across batches (``ops/clipper.
legacy_effective_query``; ``FASTX_TPU_CLIPPER_CLEAN=1`` aligns each read's
own bases instead), ``-D``/``-DD``, the float32 re-decision of
tie-fragile reads and the ``-v`` report, byte for byte.  Each batch runs
``ops/clipper.clip_batch`` on the device ``FASTX_TORCH_DEVICE`` names
(default ``cuda``), whose DP is K4 (``csrc/align_unpacked.cu``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_clipper \\
        [-h] [-a ADAPTER] [-D] [-l N] [-n] [-d N] [-c] [-C] [-k] [-M N] \\
        [-v] [-z] [-Q N] [-i INFILE] [-o OUTFILE]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ...core import codec
from ...device import resolve_device
from ...engine import hostfix
from ...engine.pipeline import padded_width
from ...kernels import align as align_dbg
from ...ops import clipper
from ...parallel import multihost
from .. import common
from ..common import CliContext, errx
from . import _shared

MAX_ADAPTER_LEN = 100

USAGE = (
    "usage: fastx_clipper [-h] [-a ADAPTER] [-D] [-l N] [-n] [-d N] [-c] [-C] [-o] [-v] [-z] [-i INFILE] [-o OUTFILE]\n"
    "Part of " + common.PACKAGE_STRING + " by A. Gordon (assafgordon@gmail.com)\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-a ADAPTER] = ADAPTER string. default is CCTTAAGG (dummy adapter).\n"
    "   [-l N]       = discard sequences shorter than N nucleotides. default is 5.\n"
    "   [-d N]       = Keep the adapter and N bases after it.\n"
    "                  (using '-d 0' is the same as not using '-d' at all. which is the default).\n"
    "   [-c]         = Discard non-clipped sequences (i.e. - keep only sequences which contained the adapter).\n"
    "   [-C]         = Discard clipped sequences (i.e. - keep only sequences which did not contained the adapter).\n"
    "   [-k]         = Report Adapter-Only sequences.\n"
    "   [-n]         = keep sequences with unknown (N) nucleotides. default is to discard such sequences.\n"
    "   [-v]         = Verbose - report number of sequences.\n"
    "                  If [-o] is specified,  report will be printed to STDOUT.\n"
    "                  If [-o] is not specified (and output goes to STDOUT),\n"
    "                  report will be printed to STDERR.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-D]	 = DEBUG output.\n"
    "   [-M N]       = require minimum adapter alignment length of N.\n"
    "                  If less than N nucleotides aligned with the adapter - don't clip it."
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "\n"
)


def tool_main(ctx: CliContext, argv) -> int:
    st = {
        "adapter": "CCTTAAGG", "min_length": 5, "discard_n": True,
        "keep_delta": 0, "discard_non_clipped": False, "discard_clipped": False,
        "show_adapter_only": False, "debug": 0, "min_adapter": 0,
    }

    def cb(args, opt, arg):
        if opt == "M":
            st["min_adapter"] = common.c_atoi(arg)
            if st["min_adapter"] <= 0:
                errx(ctx, "Invalid minimum adapter length (-M %s)" % arg)
        elif opt == "k":
            st["show_adapter_only"] = True
        elif opt == "D":
            st["debug"] += 1
        elif opt == "c":
            st["discard_non_clipped"] = True
        elif opt == "C":
            st["discard_clipped"] = True
        elif opt == "d":
            st["keep_delta"] = common.c_strtoul(arg)
            if st["keep_delta"] < 0:
                errx(ctx, "Invalid number bases to keep (-d %s)" % arg)
        elif opt == "a":
            st["adapter"] = arg[: MAX_ADAPTER_LEN - 1]
        elif opt == "l":
            st["min_length"] = common.c_strtoul(arg) & 0xFFFFFFFF
        elif opt == "n":
            st["discard_n"] = False
        elif opt == "s":
            pass  # present in the reference's option string, unhandled there

    args = common.parse_cmdline(ctx, argv, "M:kDCcd:a:s:l:n", cb, USAGE)
    keep_delta = st["keep_delta"]
    if keep_delta > 0:
        keep_delta += len(st["adapter"])

    # default: emulate the reference's grow-only matrix / stale query
    # buffer exactly (see ops.clipper.legacy_effective_query); set
    # FASTX_TPU_CLIPPER_CLEAN=1 for independent-read semantics
    legacy = not os.environ.get("FASTX_TPU_CLIPPER_CLEAN")
    carry = None

    reader = _shared.BatchReader(ctx, args, filetype=codec.FASTA_OR_FASTQ)
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()
    n_in = n_zero = n_short = n_nonclip = n_clip = n_n = 0
    tie_fix = not os.environ.get("FASTX_TPU_NO_TIE_FIX")
    for batch in reader:
        if st["debug"] > 0:
            # -D debug output (fastx_clipper.cpp:272-275): per-record
            # matrix (-DD) and alignment results, via the oracle printers
            adapter_b = st["adapter"].encode()
            for i in range(len(batch)):
                seq = bytes(np.asarray(batch.bases)[i, : int(batch.lengths[i])])
                if st["debug"] > 1:
                    ctx.stdout_text.write(align_dbg.format_matrix(seq, adapter_b))
                ctx.stdout_text.write(align_dbg.format_results(seq, adapter_b))

        eff = None
        if legacy:
            eff, widths, carry = clipper.legacy_effective_query(
                np.asarray(batch.bases), np.asarray(batch.lengths), carry
            )
        nb = len(batch)
        ll = padded_width(max(batch.width,
                              eff.shape[1] if eff is not None else 0, 1))
        bases = np.zeros((nb, ll), np.uint8)
        bases[:, : batch.width] = batch.bases
        quals = np.zeros((nb, ll), np.int8)
        quals[:, : batch.width] = batch.quals
        lengths = np.array(batch.lengths, np.int32)
        # the DP's view of the reads: the legacy emulation's, else their own
        align = {}
        if legacy:
            effp = np.zeros((nb, ll), np.uint8)
            effp[:, : eff.shape[1]] = eff
            align = {"align_bases": effp,
                     "align_lengths": np.array(widths, np.int32)}
        flags = dict(
            adapter=st["adapter"].encode(),
            min_length=st["min_length"],
            keep_delta=keep_delta,
            discard_non_clipped=st["discard_non_clipped"],
            discard_clipped=st["discard_clipped"],
            keep_n=not st["discard_n"],
            show_adapter_only=st["show_adapter_only"],
            min_adapter_len=st["min_adapter"],
        )
        bt, qt, lt = (torch.from_numpy(a).to(device)
                      for a in (bases, quals, lengths))
        res = clipper.clip_batch(
            bt, qt, lt, **flags, tie_flag=tie_fix,
            **{k: torch.from_numpy(a).to(device) for k, a in align.items()})
        b2, q2, l2, write, cat = (t.cpu().numpy() for t in res[:5])
        l2 = l2.copy()
        write = write.copy()
        cat = cat.copy()
        if tie_fix:
            frag = res[5].cpu().numpy()
            if frag.any():
                # float-fragile reads: re-decide with the bit-faithful
                # float32 engine so output matches the C exactly
                idx = np.nonzero(frag)[0]
                fl, fwr, fc = hostfix.clip_decide_np(
                    bases[idx], lengths[idx], **flags,
                    **{k: a[idx] for k, a in align.items()},
                )
                l2[idx] = fl
                write[idx] = fwr
                cat[idx] = fc
                b2 = b2.copy()
                q2 = q2.copy()
                for j, row in enumerate(idx):
                    b2[row] = bases[row]
                    q2[row] = quals[row]
                    b2[row, fl[j]:] = 0
                    q2[row, fl[j]:] = 0
        batch.bases = b2
        batch.quals = q2
        batch.lengths = l2
        out = batch.select(write)
        rc = np.asarray(batch.counts)
        n_in += int(rc.sum())
        n_zero += int(rc[cat == 1].sum())
        n_short += int(rc[cat == 2].sum())
        n_nonclip += int(rc[cat == 3].sum())
        n_clip += int(rc[cat == 4].sum())
        n_n += int(rc[cat == 5].sum())
        writer.write(_shared.render_same_as_input(args, out))
    writer.close()

    if args.verbose:
        n_in, n_short, n_nonclip, n_clip, n_n, n_zero = multihost.allsum(
            n_in, n_short, n_nonclip, n_clip, n_n, n_zero)
        rep = common.report_stream(ctx, args)
        rep.write("Clipping Adapter: %s\n" % st["adapter"])
        rep.write("Min. Length: %d\n" % st["min_length"])
        if st["discard_clipped"]:
            rep.write("Clipped reads - discarded.\n")
        if st["discard_non_clipped"]:
            rep.write("Non-Clipped reads - discarded.\n")
        rep.write("Input: %d reads.\n" % n_in)
        rep.write(
            "Output: %d reads.\n"
            % (n_in - n_short - n_nonclip - n_clip - n_n - n_zero)
        )
        rep.write("discarded %d too-short reads.\n" % n_short)
        rep.write("discarded %d adapter-only reads.\n" % n_zero)
        if st["discard_non_clipped"]:
            rep.write("discarded %d non-clipped reads.\n" % n_nonclip)
        if st["discard_clipped"]:
            rep.write("discarded %d clipped reads.\n" % n_clip)
        if st["discard_n"]:
            rep.write("discarded %d N reads.\n" % n_n)
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

"""fastx_pipeline — a chain of per-read FASTX tools as one fused pass on
the card.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_pipeline.py``: the
chain grammar (``parse_chain``, ``_stage_configs``, ``chain_to_config``)
and ``host_replay_chain`` are the reference's, copied; ``build_step`` is
the reference's traced step as an eager torch function.  The tool runs
on the device ``FASTX_TORCH_DEVICE`` names (default ``cuda``):

* FASTQ chains that map onto the fused configuration, without ``-v``,
  stream through the raw-line engine (``engine/lines.py``), unless
  ``FASTX_TPU_NO_LINEPATH`` is set;
* everything else — ``-v`` (per-stage counts), FASTA input, stages out of
  the canonical order, clipper ``-d/-c/-C/-k/-M``,
  ``fastx_reverse_complement``, ``fasta_nucleotide_changer`` — runs the
  classic per-batch loop: parse, :func:`build_step` on the card (its DP
  is K4), the float32 host replay of tie-fragile reads, render.

Output and reports are byte-identical to the reference tool's.

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline \\
        [-h] [-z] [-Q N] [-i IN] [-o OUT] 'TOOL [FLAGS] | TOOL [FLAGS] | ...'
"""

from __future__ import annotations

import itertools
import os
import shlex
import sys

import numpy as np
import torch

from ...core import codec, native
from ...core.records import BaseCode, StringColumn
from ...device import resolve_device
from ...engine import hostfix
from ...engine.lines import stream_pipeline_lines
from ...engine.pipeline import to_device
from ...ops import transforms
from ...ops.clipper import clip_batch
from ...parallel import multihost
from .. import common
from ..common import CliContext, errx
from ._shared import BatchReader

USAGE = (
    "usage: fastx_pipeline [-h] [-v] [-z] [-Q N] [-i INFILE] [-o OUTFILE] 'TOOL [FLAGS] | TOOL [FLAGS] | ...'\n"
    "Part of " + common.PACKAGE_STRING + "\n"
    "\n"
    "Runs a chain of per-read FASTX tools as one fused device pass:\n"
    "one parse, one packed pass over the whole chain on the card, one render —\n"
    "instead of the reference's one process + re-parse per stage.\n"
    "\n"
    "   [-h]         = This helpful help screen.\n"
    "   [-z]         = Compress output with GZIP.\n"
    "   [-i INFILE]  = FASTA/Q input file. default is STDIN.\n"
    "   [-o OUTFILE] = FASTA/Q output file. default is STDOUT.\n"
    "   [-Q N]       = ASCII quality offset (same as the individual tools).\n"
    "   [-v]         = Verbose - per-stage surviving read counts.\n"
    "\n"
    "Stages: fastx_trimmer [-f N] [-l N] [-t N] [-m N]\n"
    "        fastq_quality_filter [-q N] [-p N]\n"
    "        fastq_quality_trimmer [-t N] [-l N]\n"
    "        fastq_masker [-q N] [-r C]\n"
    "        fastx_clipper [-a SEQ] [-l N] [-d N] [-c] [-C] [-k] [-n] [-M N]\n"
    "        fastx_artifacts_filter\n"
    "        fastx_reverse_complement\n"
    "        fasta_nucleotide_changer [-r|-d]\n"
    "        fastq_to_fasta [-r] [-n]\n"
    "\n"
)

# per-stage mini flag grammar: optchar -> takes_arg
_STAGE_OPTS = {
    "fastx_trimmer": {"f": True, "l": True, "t": True, "m": True},
    "fastq_quality_filter": {"q": True, "p": True},
    "fastq_quality_trimmer": {"t": True, "l": True},
    "fastq_masker": {"q": True, "r": True},
    "fastx_clipper": {"a": True, "l": True, "d": True, "M": True,
                      "c": False, "C": False, "k": False, "n": False},
    "fastx_artifacts_filter": {},
    "fastx_reverse_complement": {},
    "fasta_nucleotide_changer": {"r": False, "d": False},
    "fastq_to_fasta": {"r": False, "n": False},
}

_NEEDS_QUALS = {"fastq_quality_filter", "fastq_quality_trimmer", "fastq_masker"}


def parse_chain(ctx: CliContext, spec: str):
    """'tool -x 1 | tool ...' -> list of stage dicts."""
    stages = []
    for part in spec.split("|"):
        toks = shlex.split(part)
        if not toks:
            errx(ctx, "empty pipeline stage")
        name = toks[0]
        if name not in _STAGE_OPTS:
            errx(ctx, "unsupported pipeline stage '%s'" % name)
        grammar = _STAGE_OPTS[name]
        opts = {}
        i = 1
        while i < len(toks):
            t = toks[i]
            if len(t) != 2 or t[0] != "-" or t[1] not in grammar:
                errx(ctx, "%s: invalid stage option '%s'" % (name, t))
            if grammar[t[1]]:
                if i + 1 >= len(toks):
                    errx(ctx, "%s: option -%s requires an argument" % (name, t[1]))
                opts[t[1]] = toks[i + 1]
                i += 2
            else:
                opts[t[1]] = True
                i += 1
        stages.append({"kind": name, **opts})
    return stages


def _stage_configs(ctx: CliContext, stages, is_fastq: bool):
    """Validate + normalize stage options into static python values."""
    cfgs = []
    fasta_mode = not is_fastq
    for st in stages:
        k = st["kind"]
        if k in _NEEDS_QUALS and fasta_mode:
            errx(ctx, "%s needs FASTQ input but the stream is FASTA here" % k)
        if k == "fastx_trimmer":
            c = dict(kind=k, first=int(st.get("f", 1)), last=int(st.get("l", 0)),
                     trim_end=int(st.get("t", 0)), min_len=int(st.get("m", 0)))
            if c["trim_end"] > 0 and (c["first"] != 1 or c["last"] != 0):
                errx(ctx, "fastx_trimmer: -t can not be used with -f/-l")
        elif k == "fastq_quality_filter":
            c = dict(kind=k, q=int(st.get("q", 0)), p=int(st.get("p", 0)))
            if c["q"] == 0 or c["p"] == 0:
                errx(ctx, "fastq_quality_filter: -q and -p are required")
        elif k == "fastq_quality_trimmer":
            c = dict(kind=k, t=int(st.get("t", 0)), l=int(st.get("l", 0)))
            if c["t"] == 0:
                errx(ctx, "fastq_quality_trimmer: -t is required")
        elif k == "fastq_masker":
            mask = st.get("r", "N")
            if len(mask) != 1:
                errx(ctx, "fastq_masker: mask character must be a single char")
            c = dict(kind=k, q=int(st.get("q", 10)), mask=ord(mask))
        elif k == "fastx_clipper":
            adapter = st.get("a", "CCTTAAGG")[:99]
            kd = int(st.get("d", 0))
            if kd > 0:
                kd += len(adapter)
            c = dict(kind=k, adapter=adapter.encode(), min_length=int(st.get("l", 5)),
                     keep_delta=kd, discard_non_clipped=bool(st.get("c")),
                     discard_clipped=bool(st.get("C")), keep_n=bool(st.get("n")),
                     show_adapter_only=bool(st.get("k")),
                     min_adapter=int(st.get("M", 0)))
        elif k == "fasta_nucleotide_changer":
            if bool(st.get("r")) == bool(st.get("d")):
                errx(ctx, "fasta_nucleotide_changer: use exactly one of -r / -d")
            c = dict(kind=k, rna=bool(st.get("r")))
            fasta_mode = True
        elif k == "fastq_to_fasta":
            if fasta_mode:
                errx(ctx, "fastq_to_fasta needs FASTQ input but the stream is FASTA here")
            c = dict(kind=k, rename=bool(st.get("r")), keep_n=bool(st.get("n")))
            fasta_mode = True
        elif k == "fastx_reverse_complement":
            c = dict(kind=k, is_fastq=not fasta_mode)
        else:  # fastx_artifacts_filter
            c = dict(kind=k)
        cfgs.append(c)
    return cfgs, fasta_mode


_CANONICAL = ("fastx_trimmer", "fastq_quality_filter", "fastq_quality_trimmer",
              "fastq_masker", "fastx_clipper", "fastx_artifacts_filter",
              "fastq_to_fasta")


def chain_to_config(cfgs):
    """Map a stage chain onto the fused PipelineConfig used by the
    raw-line streaming engine (engine.lines), when the chain is a
    subsequence of the canonical preprocessing order with each stage at
    most once and only fused-supported flags.  Returns
    (PipelineConfig, out_fastq), or None for a chain that needs the
    classic per-batch loop."""
    from ...engine.pipeline import PipelineConfig

    pos = -1
    for c in cfgs:
        if c["kind"] not in _CANONICAL:
            return None
        i = _CANONICAL.index(c["kind"])
        if i <= pos:
            return None
        pos = i
    kw = dict(with_filter=False, with_qtrim=False, with_mask=False,
              with_clip=False, with_artifacts=False)
    out_fastq = True
    for c in cfgs:
        k = c["kind"]
        if k == "fastx_trimmer":
            if c["first"] != 1 or c["trim_end"] != 0 or c["min_len"] != 0:
                return None
            kw["trim_last"] = c["last"]
        elif k == "fastq_quality_filter":
            kw.update(with_filter=True, filter_q=c["q"], filter_p=c["p"])
        elif k == "fastq_quality_trimmer":
            kw.update(with_qtrim=True, trim_q=c["t"], trim_minlen=c["l"])
        elif k == "fastq_masker":
            if c["mask"] != ord("N"):
                return None
            kw.update(with_mask=True, mask_q=c["q"])
        elif k == "fastx_clipper":
            if (c["keep_delta"] or c["discard_non_clipped"]
                    or c["discard_clipped"] or c["show_adapter_only"]
                    or c["min_adapter"]):
                return None
            kw.update(with_clip=True, adapter=c["adapter"],
                      clip_minlen=c["min_length"], clip_keep_n=c["keep_n"])
        elif k == "fastx_artifacts_filter":
            kw["with_artifacts"] = True
        else:  # fastq_to_fasta
            if c["rename"]:
                return None
            out_fastq = False
            kw["to_fasta_discard_n"] = not c["keep_n"]
    return PipelineConfig(**kw), out_fastq


def build_step(cfgs, tie_fix: bool = True):
    """The whole chain as one function on the batch's device.

    Returns fn(bases, quals, lengths, counts) ->
    (bases, quals, lengths, keep, per_stage_out_counts, first_forbidden,
    fragile).  With ``tie_fix`` the clipper stages flag float-fragile
    reads; those rows are EXCLUDED from the per-stage counts (the caller
    re-adds their host-replayed contributions) and replayed on the host
    with the float32 engine.
    """

    def step(bases, quals, lengths, counts):
        b, q, l = bases, quals, lengths  # noqa: E741
        dev = b.device
        keep = torch.ones(b.shape[0], dtype=torch.bool, device=dev)
        fragile = torch.zeros(b.shape[0], dtype=torch.bool, device=dev)
        stage_counts = []
        first_forbidden = torch.full((b.shape[0],), b.shape[1],
                                     dtype=torch.int32, device=dev)
        for c in cfgs:
            k = c["kind"]
            if k == "fastx_trimmer":
                b, q, l, k2 = transforms.trimmer(  # noqa: E741
                    b, q, l, first=c["first"], last=c["last"],
                    trim_end=c["trim_end"], min_len=c["min_len"],
                )
                keep &= k2
            elif k == "fastq_quality_filter":
                keep &= transforms.quality_filter_keep(
                    q, l, min_quality=c["q"], min_percent=c["p"]
                )
            elif k == "fastq_quality_trimmer":
                b, q, l, k2 = transforms.quality_trimmer(  # noqa: E741
                    b, q, l, threshold=c["t"], min_len=c["l"]
                )
                keep &= k2
            elif k == "fastq_masker":
                b, _, _ = transforms.masker(
                    b, q, l, threshold=c["q"], mask_char=c["mask"]
                )
            elif k == "fastx_clipper":
                out = clip_batch(
                    b, q, l, adapter=c["adapter"], min_length=c["min_length"],
                    keep_delta=c["keep_delta"],
                    discard_non_clipped=c["discard_non_clipped"],
                    discard_clipped=c["discard_clipped"], keep_n=c["keep_n"],
                    show_adapter_only=c["show_adapter_only"],
                    min_adapter_len=c["min_adapter"], tie_flag=tie_fix,
                )
                b, q, l, wrote = out[:4]  # noqa: E741
                if tie_fix:
                    fragile |= out[5]
                keep &= wrote
            elif k == "fastx_artifacts_filter":
                keep &= transforms.artifacts_keep(b, l)
            elif k == "fastx_reverse_complement":
                b, q = transforms.reverse_complement(b, q, l,
                                                     is_fastq=c["is_fastq"])
            elif k == "fasta_nucleotide_changer":
                b, _nchg, fb = transforms.nucleotide_changer(
                    b, l, rna_mode=c["rna"])
                # a forbidden char aborts the reference tool; only reads
                # that actually reach this stage count
                first_forbidden = torch.minimum(
                    first_forbidden, torch.where(keep, fb, b.shape[1]))
            elif k == "fastq_to_fasta":
                if not c["keep_n"]:
                    keep &= ~transforms.contains_n(b, l)
            stage_counts.append(keep.clone())
        # fragile rows are excluded from every stage tally: the caller
        # re-adds their host-replayed contributions
        counts_eff = torch.where(fragile, 0, counts).to(torch.int64)
        stage_totals = torch.stack(
            [torch.where(kk, counts_eff, 0).sum() for kk in stage_counts])
        return (b, q, l, keep, stage_totals, first_forbidden.min(),
                fragile)

    return step


def host_replay_chain(cfgs, bases, quals, lengths):
    """numpy replay of build_step for a (small) subset of reads, with the
    clipper stages decided by the bit-faithful float32 engine — the
    tie-fragile override of the classic per-batch path (mirrors
    engine/hostfix.py for the fused-engine path).  Returns
    (bases, quals, lengths, keep, keep_after_stage list)."""
    b = np.asarray(bases, np.uint8).copy()
    q = np.asarray(quals, np.int16).copy()
    l = np.asarray(lengths, np.int32).copy()  # noqa: E741
    n, W = b.shape
    cols = np.arange(W)[None, :]
    keep = np.ones(n, bool)
    keep_after = []
    for c in cfgs:
        k = c["kind"]
        in_len = cols < l[:, None]
        if k == "fastx_trimmer":
            if c["last"] != 0:
                l = np.minimum(l, c["last"])  # noqa: E741
            if c["first"] != 1:
                # the device step slices the width down (transforms.trimmer);
                # mirror it so patched rows match the device output shape
                f = c["first"]
                keep &= l >= f
                b = b[:, f - 1:]
                q = q[:, f - 1:]
                W = b.shape[1]
                cols = np.arange(W)[None, :]
                l = l - (f - 1)  # noqa: E741
            if c["trim_end"] > 0:
                keep &= l > c["trim_end"]
                l = l - c["trim_end"]  # noqa: E741
                keep &= l >= c["min_len"]
            l = np.maximum(l, 0)  # noqa: E741
            b = np.where(cols < l[:, None], b, 0).astype(np.uint8)
            q = np.where(cols < l[:, None], q, 0)
        elif k == "fastq_quality_filter":
            below = ((q < c["q"]) & in_len).sum(axis=1)
            keep &= below <= (l * (100 - c["p"])) // 100
        elif k == "fastq_quality_trimmer":
            passing = in_len & (q >= c["t"])
            pos1 = np.where(passing, cols + 1, 0)
            new_l = pos1.max(axis=1).astype(np.int32)
            keep &= (new_l > 0) & (new_l >= c["l"])
            l = new_l  # noqa: E741
            b = np.where(cols < l[:, None], b, 0).astype(np.uint8)
            q = np.where(cols < l[:, None], q, 0)
        elif k == "fastq_masker":
            b = np.where(in_len & (q < c["q"]), np.uint8(c["mask"]), b)
        elif k == "fastx_clipper":
            new_len, write, _cat = hostfix.clip_decide_np(
                b, l, c["adapter"], min_length=c["min_length"],
                keep_delta=c["keep_delta"],
                discard_non_clipped=c["discard_non_clipped"],
                discard_clipped=c["discard_clipped"], keep_n=c["keep_n"],
                show_adapter_only=c["show_adapter_only"],
                min_adapter_len=c["min_adapter"],
            )
            keep &= write
            l = new_len.astype(np.int32)  # noqa: E741
            b = np.where(cols < l[:, None], b, 0).astype(np.uint8)
            q = np.where(cols < l[:, None], q, 0)
        elif k == "fastx_artifacts_filter":
            worst = np.zeros(n, np.int64)
            for ch in b"ACGT":
                worst = np.maximum(
                    worst, ((b == ch) & (cols < l[:, None])).sum(axis=1)
                )
            keep &= ~(worst >= l - 3)
        elif k == "fastx_reverse_complement":
            comp = np.asarray(BaseCode.COMPLEMENT)[b.astype(np.int32)]
            idx = np.where(cols < l[:, None],
                           l[:, None] - 1 - cols, cols)
            b = np.take_along_axis(comp, idx, axis=1).astype(np.uint8)
            if c["is_fastq"]:
                q = np.take_along_axis(q, idx, axis=1)
        elif k == "fasta_nucleotide_changer":
            src, dst = (b"T", b"U") if c["rna"] else (b"U", b"T")
            hit = (b == src[0]) & (cols < l[:, None])
            b = np.where(hit, np.uint8(dst[0]), b)
        elif k == "fastq_to_fasta":
            if not c["keep_n"]:
                keep &= ~(((b == ord("N")) & (cols < l[:, None])).any(axis=1))
        keep_after.append(keep.copy())
    return b, q, l, keep, keep_after


def tool_main(ctx: CliContext, argv) -> int:
    # the chain spec is the last (quoted) operand; everything before it
    # is standard common flags handled by the shared parser
    argv = list(argv)
    spec = None
    if argv and not argv[-1].startswith("-"):
        head = argv[-1].split(None, 1)[0] if argv[-1].strip() else ""
        if "|" in argv[-1] or head in _STAGE_OPTS:
            spec = argv.pop()
    args = common.parse_cmdline(ctx, argv, "", None, USAGE)
    if spec is None:
        ctx.stderr.write("fastx_pipeline: missing pipeline specification\n")
        ctx.stderr.write(USAGE)
        return 1
    stages = parse_chain(ctx, spec)
    if not stages:
        errx(ctx, "empty pipeline")

    needs_fastq = any(
        s["kind"] in _NEEDS_QUALS or s["kind"] == "fastq_to_fasta"
        for s in stages
    )
    has_changer = any(s["kind"] == "fasta_nucleotide_changer" for s in stages)
    reader = BatchReader(
        ctx, args,
        filetype=codec.FASTQ_ONLY if needs_fastq else codec.FASTA_OR_FASTQ,
        allow_u=has_changer,
    )
    writer = common.OutputWriter(ctx, args)
    device = resolve_device()

    step = None
    cfgs = fasta_mode = None
    n_in = 0
    out_ordinal = 0
    stage_totals = None
    rename_output = False
    tie_fix = False
    chunks = reader.iter_chunks()
    first_chunk = next(chunks, None)
    if first_chunk is not None:
        cfgs, fasta_mode = _stage_configs(ctx, stages, reader.is_fastq)
        # the raw-line engine takes fused-supported FASTQ chains; -v needs
        # per-stage counts that only the classic per-batch loop tallies
        mapped = None
        if (reader.is_fastq and not args.verbose and native.LIB is not None
                and not os.environ.get("FASTX_TPU_NO_LINEPATH")):
            mapped = chain_to_config(cfgs)
        if mapped is not None:
            eng_cfg, eng_out_fastq = mapped
            stream_pipeline_lines(
                reader, eng_cfg, out_fastq=eng_out_fastq,
                q_offset=args.q_offset, write=writer.write, device=device,
                chunks=itertools.chain([first_chunk], chunks),
            )
            writer.close()
            return 0
        chunks = itertools.chain([first_chunk], chunks)
    else:
        chunks = ()

    for chunk, line_base in chunks:
        batch = reader.parse_chunk(chunk, line_base)
        if step is None:
            rename_output = any(
                c["kind"] == "fastq_to_fasta" and c.get("rename") for c in cfgs
            )
            tie_fix = not os.environ.get("FASTX_TPU_NO_TIE_FIX")
            step = build_step(cfgs, tie_fix=tie_fix)
            stage_totals = np.zeros(len(cfgs), np.int64)
        bases, quals, lengths, counts = to_device(batch)
        b, q, l, keep, scounts, min_fb, fragile = step(  # noqa: E741
            *(torch.from_numpy(a).to(device)
              for a in (bases, quals, lengths, counts)))
        if int(min_fb) < b.shape[1]:
            # reproduce fasta_nucleotide_changer's abort (position is
            # approximate to the batch; the reference reports per line)
            errx(ctx, "invalid nucleotide in pipeline input "
                 "(fasta_nucleotide_changer)")
        n_in += int(batch.counts.sum())
        stage_totals += scounts.cpu().numpy().astype(np.int64)
        b = b.cpu().numpy()
        q = q.cpu().numpy()
        l = l.cpu().numpy().copy()  # noqa: E741
        keep = keep.cpu().numpy().copy()
        frag = fragile.cpu().numpy() if tie_fix else None
        if tie_fix and frag.any():
            # float-tie fragile rows: replay the whole chain on the host
            # with the float32 clipper so output matches the C exactly;
            # the device excluded these rows from its stage tallies
            idx = np.nonzero(frag)[0]
            fb2, fq2, fl2, fk2, fka = host_replay_chain(
                cfgs, bases[idx], quals[idx], lengths[idx]
            )
            b = b.copy()
            q = q.copy()
            b[idx] = fb2
            q[idx] = fq2
            l[idx] = fl2
            cnt = counts[idx]
            for si in range(len(cfgs)):
                stage_totals[si] += int(cnt[fka[si]].sum())
            keep[idx] = fk2
        batch.bases = b
        batch.quals = q
        batch.lengths = l
        out = batch.select(keep)
        if rename_output:
            names = [b"%d" % (out_ordinal + i + 1) for i in range(len(out))]
            out.names = StringColumn.from_list(names)
            out.names2 = StringColumn.from_list([b""] * len(out))
        out_ordinal += len(out)
        writer.write(
            codec.render(
                out,
                out_fastq=(out.is_fastq and not fasta_mode),
                ascii_qual=out.qual_ascii if out.is_fastq else True,
                q_offset=args.q_offset,
            )
        )
    writer.close()

    if step is None:
        return 0
    if args.verbose:
        summed = multihost.allsum(n_in, *[int(t) for t in stage_totals])
        n_in, stage_totals = summed[0], list(summed[1:])
        rep = common.report_stream(ctx, args)
        rep.write("Fused pipeline: %d stages, one device program.\n"
                  % len(cfgs))
        rep.write("Input: %d reads.\n" % n_in)
        for c, total in zip(cfgs, stage_totals):
            rep.write("  %-28s -> %d reads.\n" % (c["kind"], int(total)))
        rep.write("Output: %d reads.\n" % int(stage_totals[-1]))
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

"""fastx_pipeline — a chain of per-read FASTX tools as one fused pass on
the card.

Counterpart of ``fastx_toolkit_tpu/cli/tools/fastx_pipeline.py``: the
chain grammar (``parse_chain``, ``_stage_configs``, ``chain_to_config``)
is the reference's, copied because the reference module imports jax, and
the tool runs the raw-line streaming engine (``engine/lines.py``) on the
device ``FASTX_TORCH_DEVICE`` names (default ``cuda``).  Output is
byte-identical to the reference tool's.

Not yet ported (each reports ``not supported yet``): ``-v`` and the
classic per-batch loop it needs, FASTA input, and chains the fused
engine cannot map (e.g. ``fastx_reverse_complement``, clipper ``-c``).

Usage:
    python -m fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline \\
        [-h] [-z] [-Q N] [-i IN] [-o OUT] 'TOOL [FLAGS] | TOOL [FLAGS] | ...'
"""

from __future__ import annotations

import itertools
import shlex
import sys

from ...core import codec
from ...device import resolve_device
from ...engine.lines import stream_pipeline_lines
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
    classic per-batch loop (a later port slice)."""
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
    chunks = reader.iter_chunks()
    first_chunk = next(chunks, None)
    if first_chunk is not None:
        cfgs, _fasta_mode = _stage_configs(ctx, stages, reader.is_fastq)
        if args.verbose:
            raise NotImplementedError(
                "-v needs the per-stage counts of the classic per-batch "
                "loop, a later port slice")
        if not reader.is_fastq:
            raise NotImplementedError(
                "FASTA input runs the classic per-batch loop, a later port "
                "slice")
        mapped = chain_to_config(cfgs)
        if mapped is None:
            raise NotImplementedError(
                "this chain needs the classic per-batch loop (stages out of "
                "the canonical order or flags the fused engine does not "
                "map), a later port slice")
        eng_cfg, eng_out_fastq = mapped
        stream_pipeline_lines(
            reader, eng_cfg, out_fastq=eng_out_fastq,
            q_offset=args.q_offset, write=writer.write,
            device=resolve_device(),
            chunks=itertools.chain([first_chunk], chunks),
        )
    writer.close()
    return 0


def main():
    sys.exit(common.run_tool_main(tool_main))


if __name__ == "__main__":
    main()

"""Shared glue for the port's tool front ends.

Counterpart of ``fastx_toolkit_tpu/cli/tools/_shared.py`` for one
process: ``BatchReader`` (chunked FASTA/FASTQ reading; the reference
reader's constructor also sets up multi-host byte-range sharding, which
the port does not have yet), ``render_same_as_input`` and
``in_out_report``.  Chunking, format detection and parsing are the
reference's (the port's copy of its codec), so chunks, line numbers and
error texts are identical.
"""

from __future__ import annotations

import os

import numpy as np

from ...core import codec
from ..common import ExitWithStatus


def render_same_as_input(args, batch) -> bytes:
    """OUTPUT_SAME_AS_INPUT rendering to bytes: FASTA in -> FASTA out;
    FASTQ in -> FASTQ out with each record keeping its own ASCII/numeric
    quality encoding (fastx.c:296-306)."""
    return codec.render(
        batch,
        out_fastq=batch.is_fastq,
        ascii_qual=batch.qual_ascii if batch.is_fastq else True,
        q_offset=args.q_offset,
    )


def in_out_report(rep, n_in: int, n_out: int):
    rep.write("Input: %d reads.\n" % n_in)
    rep.write("Output: %d reads.\n" % n_out)


class BatchReader:
    """Yields ``(chunk_bytes, line_number_base)`` pairs cut at whole-record
    boundaries (:meth:`iter_chunks`), parses chunks on request
    (:meth:`parse_chunk`), and iterates parsed ReadBatch objects
    (``__iter__``).  The block size defaults to FASTX_TPU_BLOCK_BYTES
    (64 MiB), as in the reference."""

    def __init__(self, ctx, args, *, filetype, allow_n=True, allow_u=False,
                 block_bytes=None, stream=None):
        self.ctx = ctx
        self.args = args
        self.filetype = filetype
        self.allow_n = allow_n
        self.allow_u = allow_u
        self.block_bytes = block_bytes or int(
            os.environ.get("FASTX_TPU_BLOCK_BYTES", 64 * 1024 * 1024))
        if stream is not None:
            self._stream = stream
        elif args.input_filename == "-" or args.input_filename.startswith("-"):
            self._stream = ctx.stdin
        else:
            try:
                self._stream = open(args.input_filename, "rb")
            except OSError as e:
                print("%s: failed to open input file '%s': %s"
                      % (ctx.prog, args.input_filename, e.strerror),
                      file=ctx.stderr)
                raise ExitWithStatus(1)
        self.is_fastq = None

    def iter_chunks(self):
        carry = b""
        line_base = 0
        first = True
        while True:
            block = self._stream.read(self.block_bytes)
            data = carry + block if carry else block
            if first:
                # empty input raises the reference's premature-EOF error
                self.is_fastq = codec.detect_format(
                    data, self.args.input_filename, self.filetype)
                first = False
            if not block:
                if data:
                    yield data, line_base
                return
            lpr = 4 if self.is_fastq else 2
            # cut at the last whole-record boundary
            count = int(np.count_nonzero(np.frombuffer(data, np.uint8) == 0x0A))
            nrec = count // lpr
            if nrec == 0:
                carry = data
                continue
            pos = len(data)
            for _ in range(count - nrec * lpr):
                pos = data.rfind(b"\n", 0, pos)
            cut = data.rfind(b"\n", 0, pos) + 1
            chunk, carry = data[:cut], data[cut:]
            yield chunk, line_base
            line_base += nrec * lpr

    def parse_chunk(self, chunk: bytes, line_base: int):
        return codec.parse(
            chunk, filetype=self.filetype, allow_n=self.allow_n,
            allow_u=self.allow_u, q_offset=self.args.q_offset,
            input_name=self.args.input_filename,
            line_number_base=line_base, is_fastq=self.is_fastq,
        )

    def __iter__(self):
        for chunk, line_base in self.iter_chunks():
            yield self.parse_chunk(chunk, line_base)

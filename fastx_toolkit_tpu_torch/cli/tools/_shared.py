"""Chunked FASTA/FASTQ reading for the port's tools.

Counterpart of ``fastx_toolkit_tpu/cli/tools/_shared.py::BatchReader``
for one process: the reference reader's constructor imports its
multi-host ``parallel`` package (and with it jax) to set up byte-range
sharding, which the port does not have yet.  Chunking, format detection
and parsing are the reference's (``fastx_toolkit_tpu.core.codec``), so
chunks, line numbers and error texts are identical.
"""

from __future__ import annotations

import numpy as np

from ...core import codec
from ..common import ExitWithStatus

BLOCK_BYTES = 64 * 1024 * 1024  # the reference reader's default block


class BatchReader:
    """Yields ``(chunk_bytes, line_number_base)`` pairs cut at whole-record
    boundaries (:meth:`iter_chunks`) and parses chunks on request
    (:meth:`parse_chunk`)."""

    def __init__(self, ctx, args, *, filetype, allow_n=True, allow_u=False,
                 block_bytes=None, stream=None):
        self.ctx = ctx
        self.args = args
        self.filetype = filetype
        self.allow_n = allow_n
        self.allow_u = allow_u
        self.block_bytes = block_bytes or BLOCK_BYTES
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

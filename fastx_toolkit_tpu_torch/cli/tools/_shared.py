"""Shared glue for the port's tool front ends.

Counterpart of ``fastx_toolkit_tpu/cli/tools/_shared.py``:
``BatchReader`` (chunked FASTA/FASTQ reading, over this process's
record-aligned byte range of the input when ``parallel/multihost`` is
active), the renderers (``render_same_as_input``,
``write_fasta``, ``write_fasta_frame``), ``in_out_report``, the per-read
tools' raw-line gate ``line_fast_path`` and their upload
``device_batch``.  Chunking, format detection and parsing are the
reference's (the port's copy of its codec), so chunks, line numbers and
error texts are identical.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...core import codec, native
from ...core.errors import FastxError
from ...engine import policy
from ...engine.pipeline import to_device
from ...parallel import multihost
from .. import common
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


def write_fasta(ctx, args, batch, role="shard"):
    """FASTA rendering of ``batch`` through a fresh ``OutputWriter`` of
    ``role``."""
    writer = common.OutputWriter(ctx, args, role=role)
    writer.write(codec.render(batch, out_fastq=False))
    writer.close()


def device_batch(batch, device):
    """A parsed batch as ``(bases, quals, lengths, counts)`` tensors on
    ``device`` (``engine.pipeline.to_device``'s padded width)."""
    return tuple(torch.from_numpy(a).to(device) for a in to_device(batch))


def in_out_report(rep, n_in: int, n_out: int):
    rep.write("Input: %d reads.\n" % n_in)
    rep.write("Output: %d reads.\n" % n_out)


def line_fast_path(reader, args):
    """Raw-line fast-path gate for a per-read tool: returns a callable
    ``attempt(chunk)`` -> FastqFrame (FastaFrame for FASTA streams, for
    tools whose reader takes FASTA) or None (the classic parser takes the
    chunk), or None when the fast path is off altogether.

    A frame comes back only for clean chunks whose bytes pass the
    reference's validation; anything else (numeric qualities, multi-line
    FASTA, framing or byte errors) goes through ``reader.parse_chunk`` so
    the error text matches the reference byte for byte (fastx.c:314-404).

    Whether the fast path is used at all is the engine policy's call
    (``engine.policy``, kind ``per-read``); ``FASTX_TPU_NO_LINEPATH=1`` or
    ``FASTX_LINEPATH=off`` force the classic parse -> device path,
    ``FASTX_LINEPATH=on`` the fast path."""
    override = os.environ.get("FASTX_LINEPATH")
    if os.environ.get("FASTX_TPU_NO_LINEPATH"):
        override = "off"
    if override == "off":
        override = "device"
    elif override == "on":
        override = "host"
    try:
        if policy.resolve("per-read", override) != "host":
            return None
    except RuntimeError:
        # FASTX_LINEPATH=on without the native library: the classic path
        # rather than a failed tool
        return None
    allowed = codec.allowed_table_u8(reader.allow_n, reader.allow_u, False)

    def attempt(chunk):
        fr = (codec.frame_fastq_fast(chunk) if reader.is_fastq
              else codec.frame_fasta_fast(chunk))
        if fr is None:
            return None
        if native.validate_records(
                fr.buf, fr.seq_starts, fr.seq_lens,
                getattr(fr, "qual_starts", None), allowed,
                args.q_offset) != -1:
            return None
        return fr

    return attempt


def write_fasta_frame(writer, args, fr, new_lens, keep, *, seq_starts=None,
                      counts=None):
    """Render a FastaFrame's surviving records with the span renderer and
    return ``(in_reads, out_reads)``: weighted by the collapsed
    multiplicities when ``counts`` is given (FASTA reports,
    fastx.c:475-495), else plain record counts."""
    ss = fr.seq_starts if seq_starts is None else seq_starts
    kb = np.asarray(keep, bool) if keep is not None else None
    if counts is None:
        n_in = len(fr)
        n_out = int(kb.sum()) if kb is not None else len(fr)
    else:
        counts = np.asarray(counts, np.int64)
        n_in = int(counts.sum())
        n_out = int(counts[kb].sum()) if kb is not None else n_in
    writer.write(native.render_lines(
        fr.buf, fr.name_starts, fr.name_lens, ss, ss, None, None,
        new_lens, None if kb is None else kb.astype(np.uint8),
        out_fastq=False, q_offset=args.q_offset,
    ))
    return n_in, n_out


class BatchReader:
    """Yields ``(chunk_bytes, line_number_base)`` pairs cut at whole-record
    boundaries (:meth:`iter_chunks`), parses chunks on request
    (:meth:`parse_chunk`), and iterates parsed ReadBatch objects
    (``__iter__``).  The block size defaults to FASTX_TPU_BLOCK_BYTES
    (64 MiB), as in the reference.

    Multi-process/sharded runs (parallel.multihost active): the input file
    is split by byte ranges — this reader owns
    ``[resync(k*size/N), resync((k+1)*size/N))``, resynced to record
    boundaries, so every record belongs to exactly one process and the
    shards concatenate in file order.  Requires a seekable input file;
    format is detected once from the file head so all shards agree.
    Validation-error line numbers are shard-local in this mode.  Every
    reader-based path (the parsed batches, the raw-line host paths and
    the line engine, which all consume :meth:`iter_chunks`) inherits the
    range."""

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
        self._shard = multihost.shard_info()
        self._shard_start = self._shard_end = None
        if self._shard.active:
            self._init_shard_range()

    def _init_shard_range(self):
        f = self._stream
        if (
            (self.ctx is not None and f is self.ctx.stdin)
            or not (hasattr(f, "seekable") and f.seekable())
            or not hasattr(f, "fileno")
        ):
            raise FastxError(
                "sharded/multi-host input requires a seekable input file "
                "(-i FILE), not STDIN or a pipe"
            )
        size = os.fstat(f.fileno()).st_size
        f.seek(0)
        head = f.read(min(size, 1 << 16))
        # format decided from the file head so every shard agrees; an
        # empty file raises the reference's premature-EOF error here
        self.is_fastq = codec.detect_format(
            head, self.args.input_filename, self.filetype)
        self._shard_start, self._shard_end = multihost.shard_byte_range(
            f, size, self.is_fastq, self._shard)
        f.seek(self._shard_start)

    def iter_chunks(self):
        carry = b""
        line_base = 0
        first = True
        remaining = None
        if self._shard.active:
            first = False  # format already detected from the file head
            remaining = self._shard_end - self._shard_start
            if remaining <= 0:
                return
        while True:
            want = (self.block_bytes if remaining is None
                    else min(self.block_bytes, remaining))
            block = self._stream.read(want) if want > 0 else b""
            if remaining is not None:
                remaining -= len(block)
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

"""Streaming raw-line pipeline engine on the card.

Counterpart of ``fastx_toolkit_tpu/engine/lines.py:69-497``, with the
same order semantics:

* chunks are framed into raw line spans (``codec.frame_fastq_fast``) and
  validated natively; the 2-bit upload is packed straight from the spans
  (``native.pack2_lines``) into exactly-``chunk_rows`` dispatches, with a
  grow-only width, a bounded number of dispatches in flight and a drainer
  thread, so the device work overlaps parsing;
* the device returns only (new_length, keep, tie_fragile) per read;
  output is rendered from the spans and the decisions with the masker's
  byte edit fused in (``native.render_lines``);
* tie_fragile reads are re-decided on the host in float32
  (:mod:`.hostfix`) on one worker thread, in render order.

On CUDA each dispatch is copied from pinned host buffers with
``non_blocking=True`` on a stream owned by :class:`LineEngines`; the
producer thread launches the decisions body on that stream, starts the
copies of the results back into pinned buffers, and records an event.
The drainer waits on the event before it reads the results.  (PyTorch's
current stream is per thread, so no work relies on the default stream
across threads.)

Chunks the reference sends down its classic unpacked path (numeric
qualities, byte errors, non-ACGTN alphabets, reads over 25,000 bp) are
parsed in full (a malformed chunk raises the reference's exact
FastxError), padded to the reference's width and dispatched, in
read order between the fast spans, through the unpacked decisions body
(``engine/pipeline.py::decisions_pipeline``, whose DP is K4); they render
through ``codec.render`` with each record's own quality representation.

The reference memoizes traced programs and must invalidate them when a
trace-time env knob changes (its ``_TRACE_ENV_KNOBS``); the port runs
eagerly and keeps no program memo, so that gap does not arise here.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..core import codec, native
from .pipeline import (
    PipelineConfig,
    _thresholds,
    decisions_pipeline,
    packed_decisions_pipeline,
    to_device,
)

CHUNK = int(os.environ.get("FASTX_TPU_CHUNK", 262144))


class _Dispatch:
    """One dispatched chunk's decisions ``(l, keep, fragile)``;
    :meth:`result` waits for the device and returns them as numpy
    arrays."""

    def __init__(self, outs, event=None, keep_alive=None):
        self.outs = outs
        self.event = event
        self.keep_alive = keep_alive  # host inputs of in-flight copies

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy() for t in self.outs)


class LineEngines:
    """Per-config dispatch state, reused across streams: the device, the
    CUDA stream the dispatches run on, and the tie-fix switch.

    When the chain includes the clipper, the DP runs with the
    tie-fragility flag and the stream re-decides flagged reads with the
    float32 host engine (:mod:`.hostfix`); FASTX_TPU_NO_TIE_FIX=1 turns
    that off, as in the reference.  ``fragile_rows`` counts the reads
    re-decided so far."""

    def __init__(self, cfg: PipelineConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.fragile_rows = 0

    @property
    def tie(self) -> bool:
        return bool(self.cfg.with_clip) and not os.environ.get(
            "FASTX_TPU_NO_TIE_FIX")

    def host_buffers(self, B: int, nb4: int, n_planes: int, nb8: int):
        """Zeroed host upload buffers (pinned when the device is CUDA):
        ``(b2, planes, lengths)`` tensors."""
        pin = self.stream is not None
        return (torch.zeros((B, nb4), dtype=torch.uint8, pin_memory=pin),
                torch.zeros((B, n_planes, nb8), dtype=torch.uint8,
                            pin_memory=pin),
                torch.zeros(B, dtype=torch.int16, pin_memory=pin))

    def _run(self, body, host_in):
        """Run ``body`` on the device over the host inputs; on CUDA the
        uploads, the body and the copies of its results back into pinned
        buffers are queued on the engine's stream, and an event marks
        their end."""
        if self.stream is None:
            return _Dispatch(body(*host_in))
        with torch.cuda.stream(self.stream):
            dev_in = [torch.as_tensor(t).to(self.device, non_blocking=True)
                      for t in host_in]
            outs = body(*dev_in)
            host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True).copy_(
                                         t, non_blocking=True)
                         for t in outs)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return _Dispatch(host, ev, host_in)

    def fn2(self, has_n: bool):
        """The dispatch function for 2-bit chunks with (``has_n``) or
        without an N plane: ``(b2, planes, lengths)`` host tensors ->
        :class:`_Dispatch`."""
        tie = self.tie

        def run(b2, planes, lengths):
            seq_len = int(lengths.max()) if len(lengths) else 0
            return self._run(
                lambda *a: packed_decisions_pipeline(
                    self.cfg, *a, has_n_plane=has_n, device=self.device,
                    tie_flag=tie, seq_len=seq_len),
                (b2, planes, lengths))

        return run

    def unpacked(self):
        """The dispatch function for classic chunks: width-padded ``(bases,
        quals, lengths, counts)`` host arrays -> :class:`_Dispatch`.  The
        counts go up only for the stats reduction, whose result the
        stream drops, as the reference's does."""
        tie = self.tie
        if not self.cfg.with_stats:
            return lambda bases, quals, lengths, _counts: self._run(
                lambda *a: decisions_pipeline(self.cfg, *a,
                                              device=self.device,
                                              tie_flag=tie),
                (bases, quals, lengths))
        return lambda bases, quals, lengths, counts: self._run(
            lambda b, q, ln, c: decisions_pipeline(
                self.cfg, b, q, ln, device=self.device, tie_flag=tie,
                counts=c)[:3],
            (bases, quals, lengths, counts))


def stream_pipeline_lines(reader, cfg: PipelineConfig, *, out_fastq: bool,
                          q_offset: int, write, device,
                          arena: Optional[np.ndarray] = None,
                          chunk_rows: int = CHUNK,
                          engines: Optional[LineEngines] = None,
                          chunks=None):
    """Stream ``reader`` through the fused chain on ``device``; emit the
    rendered bytes.

    ``write(b)`` receives the output in input order (ignored when
    ``arena`` is given — then bytes land in the arena).  ``chunks``
    optionally supplies the ``(chunk, line_base)`` iterator (callers that
    consumed the head of ``reader.iter_chunks()`` pass the rechained
    iterator).  Returns ``(n_records_in, n_records_out, bytes_out)``.
    """
    if native.LIB is None:
        raise RuntimeError("stream_pipeline_lines requires the native codec")
    if engines is None:
        engines = LineEngines(cfg, device)
    if chunks is None:
        chunks = reader.iter_chunks()
    thresholds = _thresholds(cfg)
    allowed = codec.allowed_table_u8(reader.allow_n, reader.allow_u, False)
    inflight_max = int(os.environ.get("FASTX_BENCH_INFLIGHT", 2))

    blocks_q: "queue.Queue" = queue.Queue()
    futs_q: "queue.Queue" = queue.Queue(maxsize=32)
    inflight_q: "queue.Queue" = queue.Queue(maxsize=max(1, inflight_max - 1))
    err = []

    tie = engines.tie

    # per-leg trace (FASTX_LINES_TRACE=1): cumulative seconds per leg;
    # frame/pack/dispatch-stall run on the producer thread, drain on the
    # drainer, render on the caller's thread — the legs overlap
    trace = bool(os.environ.get("FASTX_LINES_TRACE"))
    tr = {"frame+scan": 0.0, "pack": 0.0, "dispatch_stall": 0.0,
          "drain(link)": 0.0, "render": 0.0}

    def _timed(leg, f, *a, **k):
        if not trace:
            return f(*a, **k)
        t0 = time.perf_counter()
        r = f(*a, **k)
        tr[leg] += time.perf_counter() - t0
        return r

    def drain():
        try:
            while True:
                item = inflight_q.get()
                if item is None:
                    break
                nrows, fut = item
                futs_q.put((nrows, *_timed("drain(link)", fut.result)))
        except BaseException as e:
            err.append(e)
            # keep consuming so the producer never blocks forever on the
            # bounded queue after a device failure; the error re-raises
            # in the consuming thread
            while True:
                item = inflight_q.get()
                if item is None:
                    break
        finally:
            futs_q.put(None)

    def produce():
        segs = []  # (frame, lo, hi) awaiting a full dispatch chunk
        pend = 0
        any_n = False
        w_run = [8]  # grow-only dispatch width (multiple of 8)

        def flush(rows):
            nonlocal segs
            take, got = [], 0
            while got < rows:
                fr, lo, hi = segs[0]
                need = rows - got
                if hi - lo <= need:
                    take.append(segs.pop(0))
                    got += hi - lo
                else:
                    take.append((fr, lo, lo + need))
                    segs[0] = (fr, lo + need, hi)
                    got = rows
            W = max(int(fr.seq_lens[lo:hi].max()) if hi > lo else 1
                    for fr, lo, hi in take)
            w_run[0] = max(w_run[0], -(-W // 8) * 8)
            W = w_run[0]
            # (the reference pads a short tail dispatch to chunk_rows to
            # keep one compiled shape; an eager port has no shape to keep)
            B = rows
            n_planes = len(thresholds) + (1 if any_n else 0)
            b2, planes, lengths = engines.host_buffers(
                B, (W + 3) // 4, n_planes, (W + 7) // 8)
            b2_np, planes_np, lengths_np = b2.numpy(), planes.numpy(), \
                lengths.numpy()
            r0 = 0
            for fr, lo, hi in take:
                nseg = hi - lo
                _timed(
                    "pack", native.pack2_lines,
                    fr.buf, fr.seq_starts[lo:hi], fr.qual_starts[lo:hi],
                    fr.seq_lens[lo:hi], W, q_offset, thresholds, any_n,
                    b2_out=b2_np, planes_out=planes_np, row0=r0,
                )
                lengths_np[r0:r0 + nseg] = fr.seq_lens[lo:hi]
                r0 += nseg
            fut = engines.fn2(any_n)(b2, planes, lengths)
            _timed("dispatch_stall", inflight_q.put, (rows, fut))

        def flush_all():
            nonlocal pend
            while pend >= chunk_rows:
                pend -= chunk_rows
                flush(chunk_rows)
            if pend:
                flush(pend)
                pend = 0

        try:
            for chunk, line_base in chunks:
                fr = None
                has_n = False
                if reader.is_fastq:
                    fr = _timed("frame+scan", codec.frame_fastq_fast, chunk)
                if fr is not None and _timed(
                    "frame+scan", native.validate_records,
                    fr.buf, fr.seq_starts, fr.seq_lens, fr.qual_starts,
                    allowed, q_offset,
                ) != -1:
                    fr = None  # byte error: the full parser raises exactly
                if fr is not None and len(fr) and int(fr.seq_lens.max()) > 25000:
                    fr = None  # beyond the int16 length column
                if fr is not None:
                    pure, has_n = native.scan_lines(
                        fr.buf, fr.seq_starts, fr.seq_lens
                    )
                    if not pure:
                        fr = None
                if fr is None:
                    # classic chunk: flush pending spans first so the
                    # decisions stay in read order, then dispatch the
                    # parsed batch through the unpacked body
                    flush_all()
                    batch = reader.parse_chunk(chunk, line_base)
                    bases, quals, lengths, counts = to_device(batch)
                    fut = engines.unpacked()(bases, quals, lengths, counts)
                    blocks_q.put(("classic", batch))
                    inflight_q.put((len(batch), fut))
                    continue
                if has_n and not any_n and pend:
                    # an N-bearing chunk after N-free ones changes the
                    # packed-plane layout; flush so dispatches stay uniform
                    flush_all()
                any_n = any_n or has_n
                blocks_q.put(("fast", fr))
                segs.append((fr, 0, len(fr)))
                pend += len(fr)
                while pend >= chunk_rows:
                    pend -= chunk_rows
                    flush(chunk_rows)
            if pend:
                flush(pend)
        except BaseException as e:
            err.append(e)
        finally:
            blocks_q.put(None)
            inflight_q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t_drain = threading.Thread(target=drain, daemon=True)
    t_drain.start()

    n_total = 0
    n_out = 0
    out_pos = 0
    cur = None  # [kind, block, new_len, keep, fill, fragile]
    spill_len = spill_keep = spill_frag = None
    mask_thr = cfg.mask_q if cfg.with_mask else None

    def next_block():
        nonlocal cur, spill_len, spill_keep, spill_frag
        item = blocks_q.get()
        if item is None:
            cur = None
            return False
        kind, blk = item
        n = len(blk)
        cur = [kind, blk, np.empty(n, np.int32), np.empty(n, bool), 0,
               np.zeros(n, bool) if tie else None]
        if spill_len is not None:
            take = min(len(spill_len), n)
            cur[2][:take] = spill_len[:take]
            cur[3][:take] = spill_keep[:take]
            if tie:
                cur[5][:take] = spill_frag[:take]
            cur[4] = take
            more = take < len(spill_len)
            spill_len = spill_len[take:] if more else None
            spill_keep = spill_keep[take:] if more else None
            spill_frag = spill_frag[take:] if (more and tie) else None
        return True

    def render_block(kind, blk, new_len, keep):
        nonlocal out_pos, n_out
        n_out += int(keep.sum())
        if kind == "fast":
            r = native.render_lines(
                blk.buf, blk.name_starts, blk.name_lens, blk.seq_starts,
                blk.qual_starts, blk.name2_starts, blk.name2_lens,
                new_len, keep.astype(np.uint8), out_fastq=out_fastq,
                q_offset=q_offset, mask_thr=mask_thr,
                out=arena, out_off=out_pos if arena is not None else 0,
            )
        else:
            blk.lengths = new_len
            # keep each record's quality representation: a classic chunk
            # may carry numeric-quality records, re-emitted numerically
            ascii_q = (blk.qual_ascii
                       if (blk.is_fastq and blk.qual_ascii is not None)
                       else True)
            r = codec.render(
                blk, out_fastq=out_fastq, ascii_qual=ascii_q,
                q_offset=q_offset, keep=keep, mask_thr=mask_thr,
                out=arena, out_off=out_pos if arena is not None else 0,
            )
        if arena is not None:
            out_pos += r
        else:
            out_pos += len(r)
            write(r)

    # tie-fragile fixes run on one worker thread so the float32 re-decides
    # overlap the consumer's waits on the device; `ready` holds completed
    # blocks in render order, each with its pending fix (or None)
    fixpool = ThreadPoolExecutor(max_workers=1) if tie else None
    ready: "deque" = deque()

    def drain_ready(block: bool):
        nonlocal n_total
        while ready:
            kind, blk, new_len, keep, fut = ready[0]
            if fut is not None and not block and not fut.done():
                return
            if fut is not None:
                fut.result()  # re-raises fixer errors in the consumer
            ready.popleft()
            _timed("render", render_block, kind, blk, new_len, keep)
            n_total += len(blk)

    def flush_if_done():
        nonlocal cur
        while cur is not None and cur[4] == len(cur[1]):
            kind, blk, new_len, keep, _, frag = cur
            fut = None
            if tie and frag.any():
                engines.fragile_rows += int(frag.sum())
                fut = fixpool.submit(_fix_fragile, cfg, kind, blk, new_len,
                                     keep, frag, q_offset)
            ready.append((kind, blk, new_len, keep, fut))
            if not next_block():
                break
        drain_ready(block=False)

    try:
        if not next_block():
            t.join()
            t_drain.join()
            if err:
                raise err[0]
            return 0, 0, 0
        while True:
            item = futs_q.get()
            if item is None:
                break
            nrows, l, k, fg = item
            dlen = l[:nrows]
            dkeep = k[:nrows]
            dfrag = fg[:nrows] if tie else None
            pos = 0
            while pos < nrows and cur is not None:
                room = len(cur[1]) - cur[4]
                take = min(room, nrows - pos)
                cur[2][cur[4]:cur[4] + take] = dlen[pos:pos + take]
                cur[3][cur[4]:cur[4] + take] = dkeep[pos:pos + take]
                if tie:
                    cur[5][cur[4]:cur[4] + take] = dfrag[pos:pos + take]
                cur[4] += take
                pos += take
                flush_if_done()
            if pos < nrows:
                spill_len = dlen[pos:]
                spill_keep = dkeep[pos:]
                spill_frag = dfrag[pos:] if tie else None
        drain_ready(block=True)
    finally:
        if fixpool is not None:
            fixpool.shutdown(wait=False)
    t.join()
    t_drain.join()
    if err:
        raise err[0]
    if trace:
        import sys

        print(
            "lines trace: "
            + "  ".join("%s=%.3fs" % (k, v) for k, v in tr.items())
            + "  (frame/pack/stall on producer, drain on drainer, "
            "render on caller; legs overlap across threads)",
            file=sys.stderr,
        )
    return n_total, n_out, out_pos


def _fix_fragile(cfg, kind, blk, new_len, keep, frag, q_offset):
    """Re-decide tie-fragile rows with the float32 host engine and patch
    the decisions in place."""
    from . import hostfix

    idx = np.nonzero(frag)[0]
    if kind == "classic":
        b = np.ascontiguousarray(blk.bases[idx])
        q = np.ascontiguousarray(blk.quals[idx]).astype(np.int16)
        ln = np.asarray(blk.lengths)[idx].astype(np.int32)
    else:
        lens = np.ascontiguousarray(blk.seq_lens[idx])
        lm = max(int(lens.max()), 1)
        buf = np.frombuffer(blk.buf, np.uint8)
        b = native.gather_rows(
            buf, np.ascontiguousarray(blk.seq_starts[idx]), lens, lm
        )
        qa = native.gather_rows(
            buf, np.ascontiguousarray(blk.qual_starts[idx]), lens, lm
        )
        # beyond-length cells are unset; every consumer masks by length
        q = qa.astype(np.int16) - q_offset
        ln = lens.astype(np.int32)
    l_fix, k_fix = hostfix.host_decide(cfg, b, q, ln)
    new_len[idx] = l_fix
    keep[idx] = k_fix

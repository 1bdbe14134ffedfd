"""Multi-process streaming execution front end.

Counterpart of ``fastx_toolkit_tpu/parallel/multihost.py``.  The
reference is a single-process streaming program
(FASTX-Toolkit's fastx.c:314-404: one record at a time through one
FILE*).  This module scales that contract to N cooperating processes
with DATA parallelism over reads:

* every process runs the *same* tool command line;
* the input file is split by byte ranges — process k of N reads
  ``[resync(k*size/N), resync((k+1)*size/N))`` where ``resync`` advances
  to the next record boundary, so each record is owned by exactly one
  process and shard order concatenates to file order;
* per-read streaming tools write their own output shard
  (``FILE.shard-00000-of-00002`` ... or each process's stdout) whose
  in-order concatenation is byte-identical to a single-process run;
* global operators (quality-stats histograms, collapse tables, verbose
  report counters) merge across processes with host-level allgathers
  over a ``torch.distributed`` process group on the gloo backend (CPU
  tensors, so they serve a machine with one card as well as a CPU-only
  one), and only process 0 renders the merged result/report —
  byte-identical to a single-process run.

Activation is environment-driven, with the reference's names and
meanings, so tool flag surfaces stay byte-identical to the reference:

* ``FASTX_TPU_COORDINATOR=host:port`` + ``FASTX_TPU_NUM_PROCESSES`` +
  ``FASTX_TPU_PROCESS_ID`` — full multi-process mode: the gloo process
  group comes up (``init_method="tcp://" + coordinator``; process 0
  hosts the store) and collective merges are available (reports and
  global outputs are merged, printed once).  A peer that does not join,
  or a collective a peer never reaches, fails after ``TIMEOUT_S``
  seconds instead of hanging the run.
* ``FASTX_TPU_NUM_SHARDS`` + ``FASTX_TPU_SHARD_ID`` — shard-only mode:
  input byte-range sharding without a process group (GNU-parallel
  style).  Each shard writes its own output and its own per-shard
  verbose report; global tools refuse to merge.

Record-boundary resync soundness (why the scan below cannot mis-frame):
FASTA: a record starts at every line whose first byte is ``>``
(sequence lines never contain ``>``).  FASTQ: a line L is a record
header iff ``L[0] == '@'`` and the line two below starts with ``+``.
Proof: the 4-line cycle is H(@...), S, P(+...), Q.  S never starts with
``@`` (nucleotide alphabet) and P starts with ``+``; the only other
line that may start with ``@`` is Q (ASCII quality 31 at offset 33),
but two lines below Q sits S' (next record's sequence line), which
never starts with ``+``.  Numeric-quality lines start with a digit,
space or ``-``.  Hence the predicate holds for H and only H.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import Optional

import numpy as np

ENV_COORDINATOR = "FASTX_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "FASTX_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "FASTX_TPU_PROCESS_ID"
ENV_NUM_SHARDS = "FASTX_TPU_NUM_SHARDS"
ENV_SHARD_ID = "FASTX_TPU_SHARD_ID"

# how long the group's rendezvous and each merge wait for a peer
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    process_id: int
    num_processes: int
    collective: bool  # the torch.distributed process group is live

    @property
    def active(self) -> bool:
        return self.num_processes > 1

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


_INFO: Optional[ShardInfo] = None


def initialize() -> ShardInfo:
    """Resolve the shard/process-group configuration (idempotent).

    Called early by cli.common.run_tool_main so the process group comes
    up before any tool code runs; safe to call lazily from library code.
    """
    global _INFO
    if _INFO is not None:
        return _INFO
    coord = os.environ.get(ENV_COORDINATOR)
    if coord:
        nproc = int(os.environ[ENV_NUM_PROCESSES])
        pid = int(os.environ[ENV_PROCESS_ID])
        if nproc > 1:
            import torch.distributed as dist

            if not dist.is_initialized():
                dist.init_process_group(
                    "gloo", init_method="tcp://" + coord,
                    world_size=nproc, rank=pid,
                    timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _INFO = ShardInfo(pid, nproc, nproc > 1)
    elif os.environ.get(ENV_NUM_SHARDS):
        nshards = int(os.environ[ENV_NUM_SHARDS])
        sid = int(os.environ.get(ENV_SHARD_ID, "0"))
        if not 0 <= sid < nshards:
            raise ValueError(
                "%s=%d out of range for %s=%d" % (ENV_SHARD_ID, sid, ENV_NUM_SHARDS, nshards)
            )
        _INFO = ShardInfo(sid, nshards, False)
    else:
        _INFO = ShardInfo(0, 1, False)
    return _INFO


def shard_info() -> ShardInfo:
    return initialize()


def _reset_for_tests() -> None:
    global _INFO
    _INFO = None


def shard_suffix(filename: str, info: Optional[ShardInfo] = None) -> str:
    info = info or shard_info()
    return "%s.shard-%05d-of-%05d" % (filename, info.process_id, info.num_processes)


# ---------------------------------------------------------------------------
# byte-range sharding


def byte_range(size: int, process_id: int, num_processes: int) -> tuple:
    """Naive (pre-resync) byte range [lo, hi) for one process."""
    lo = size * process_id // num_processes
    hi = size * (process_id + 1) // num_processes
    return lo, hi


def resync_to_record(f, offset: int, size: int, is_fastq: bool) -> int:
    """Smallest byte position >= offset at which a record begins.

    ``f`` is a seekable binary file of ``size`` bytes; returns ``size``
    when no record starts at or after ``offset``.  See the module
    docstring for why the header predicate is sound.
    """
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    chunk = 1 << 20
    # read from offset-1 so "offset is a line start" is decidable from
    # the previous byte being a newline
    base = offset - 1
    buf = b""
    scanned = 0  # candidates already rejected (index into line starts)
    while True:
        f.seek(base + len(buf))
        more = f.read(chunk)
        buf += more
        eof = not more
        arr = np.frombuffer(buf, np.uint8)
        starts = np.flatnonzero(arr == 0x0A) + 1  # buf indices of line starts
        k = scanned
        need_more = False
        while k < len(starts):
            j = int(starts[k])
            if j >= len(buf):
                need_more = True  # newline is the last byte read so far
                break
            c = buf[j]
            if not is_fastq:
                if c == 0x3E:  # '>'
                    return base + j
                k += 1
                continue
            if c != 0x40:  # '@'
                k += 1
                continue
            # header iff the line two below starts with '+' (see module doc)
            if k + 2 >= len(starts) or int(starts[k + 2]) >= len(buf):
                if eof:
                    return size  # truncated record at EOF
                need_more = True
                break
            if buf[int(starts[k + 2])] == 0x2B:  # '+'
                return base + j
            k += 1
        scanned = k
        if eof:
            return size  # no further data can complete a record start


def resync_to_line(f, offset: int, size: int) -> int:
    """Smallest byte position >= offset at which a line begins (for
    line-record tools like the tabular uncollapser)."""
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    pos = offset - 1
    f.seek(pos)
    while True:
        chunk = f.read(1 << 20)
        if not chunk:
            return size
        i = chunk.find(b"\n")
        if i >= 0:
            return pos + i + 1
        pos += len(chunk)


def shard_line_range(f, size: int, info: Optional[ShardInfo] = None) -> tuple:
    """Line-aligned byte range [lo, hi) owned by this process."""
    info = info or shard_info()
    lo, hi = byte_range(size, info.process_id, info.num_processes)
    return resync_to_line(f, lo, size), resync_to_line(f, hi, size)


def shard_byte_range(f, size: int, is_fastq: bool,
                     info: Optional[ShardInfo] = None) -> tuple:
    """Record-aligned byte range [lo, hi) owned by this process."""
    info = info or shard_info()
    lo, hi = byte_range(size, info.process_id, info.num_processes)
    return (
        resync_to_record(f, lo, size, is_fastq),
        resync_to_record(f, hi, size, is_fastq),
    )


# ---------------------------------------------------------------------------
# host-level collectives (gloo all_gather over CPU tensors)


def _process_allgather(arr: np.ndarray) -> np.ndarray:
    """``arr`` from every process, stacked on a new leading axis in rank
    order (the reference's ``process_allgather``)."""
    import torch
    import torch.distributed as dist

    # guard against a group that did not form as requested: a merge over
    # fewer processes would return partial results as if they were global
    expect = shard_info().num_processes
    got = dist.get_world_size() if dist.is_initialized() else 1
    if got != expect:
        raise RuntimeError(
            "multi-process merge needs a %d-process torch.distributed group "
            "but its world size is %d; every process must join the group "
            "(%s, %s, %s)" % (expect, got, ENV_COORDINATOR,
                              ENV_NUM_PROCESSES, ENV_PROCESS_ID)
        )
    local = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(local) for _ in range(got)]
    dist.all_gather(parts, local)
    return torch.stack(parts).numpy()


def allsum(*values: int):
    """Sum integer counters across processes (identity when not in
    collective mode, so per-tool verbose paths can call it
    unconditionally).  Returns a tuple matching the inputs."""
    info = shard_info()
    if not (info.active and info.collective):
        return tuple(values)
    g = _process_allgather(np.asarray(values, np.int64))
    return tuple(int(x) for x in g.sum(axis=0))


def allgather_bytes(payload: bytes) -> list:
    """Gather one bytes payload from every process (collective mode)."""
    info = shard_info()
    if not (info.active and info.collective):
        return [payload]
    sizes = _process_allgather(np.asarray([len(payload)], np.int64))[:, 0]
    m = int(sizes.max())
    buf = np.zeros(max(m, 1), np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    g = _process_allgather(buf)
    return [g[i, : int(sizes[i])].tobytes() for i in range(len(sizes))]


def allgather_object(obj) -> list:
    """Gather one picklable object from every process (collective mode).
    Used for host-side merge state (collapse tables, stats arrays); the
    payloads are produced by this same trusted process group."""
    return [pickle.loads(b) for b in allgather_bytes(pickle.dumps(obj))]


def global_record_offset(n_local_records: int) -> int:
    """Records processed by lower-ranked shards (shards are byte-ordered,
    so global record index = local index + this offset)."""
    info = shard_info()
    if not (info.active and info.collective):
        return 0
    g = _process_allgather(np.asarray([n_local_records], np.int64))[:, 0]
    return int(g[: info.process_id].sum())


def merge_stats_accumulators(acc):
    """Merge per-process StatsAccumulator state: pad every process's
    arrays to the global max cycle count, then +/min/max-reduce —
    exactly the all_reduce SUM/MIN/MAX semantics of parallel.mesh.
    sharded_stats, lifted to host state so variable-shape streaming
    shards compose."""
    from ..ops.stats import StatsAccumulator

    info = shard_info()
    if not (info.active and info.collective):
        return acc
    parts = allgather_object(
        (acc.count, acc.hist, acc.qsum, acc.qmin, acc.qmax)
    )
    merged = StatsAccumulator.empty(0)
    for p in parts:
        merged.merge_partial(*p)
    return merged


class NullTextStream:
    """Swallows report text on non-primary processes."""

    def write(self, s) -> int:
        return len(s)

    def flush(self) -> None:
        pass

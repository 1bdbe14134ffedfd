"""Host-side FASTA/FASTQ codec: bytes <-> ReadBatch, vectorized.

Reproduces the observable behavior of the reference record reader/writer
(FASTX-Toolkit src/libfastx/fastx.c) — format autodetection by first
character (fastx.c:86-116), 2-line FASTA / 4-line FASTQ framing with
validation and exact error text (fastx.c:314-404), ASCII-vs-numeric
quality detection by line length (fastx.c:382-390), collapsed-id read
counts (fastx.c:475-495), and byte-identical record rendering
(fastx.c:406-473) — but over whole batches with numpy instead of
per-record fgets/fprintf loops.
"""

from __future__ import annotations

import re
from typing import Optional, Union

import numpy as np

from .errors import FastxError
from .records import ReadBatch, StringColumn
from . import native

FASTA_ONLY = "fasta_only"
FASTQ_ONLY = "fastq_only"
FASTA_OR_FASTQ = "any"

MIN_QUALITY_VALUE = -15
MAX_QUALITY_VALUE = 93

_STRTOL_RE = re.compile(rb"[ \t\n\v\f\r]*[+-]?[0-9]+")
_ATOI_RE = re.compile(rb"^[ \t\n\v\f\r]*\+?(-?[0-9]+)")


def _allowed_byte_table(allow_n: bool, allow_u: bool, allow_lower: bool) -> np.ndarray:
    """The reference's allowed_nucleotides[256] table (fastx.c:56-84)."""
    table = np.zeros(256, dtype=bool)
    for ch in b"ACGT":
        table[ch] = True
    if allow_n:
        table[ord("N")] = True
    if allow_u:
        table[ord("U")] = True
    if allow_lower:
        for ch in b"acgt":
            table[ch] = True
        if allow_n:
            table[ord("n")] = True
        if allow_u:
            table[ord("u")] = True
    return table


def _split_lines(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Line framing + chomp.

    Returns (starts, ends, buf) where ends already account for the
    reference's chomp() truncating each line at its first CR or LF
    (FASTX-Toolkit src/libfastx/chomp.c:34-44).
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if native.LIB is not None and len(buf):
        starts, has_cr = native.index_lines(buf)
        nlines = len(starts)
        ends = np.empty(nlines, dtype=np.int64)
        ends[:-1] = starts[1:] - 1
        ends[-1] = len(buf) - 1 if data.endswith(b"\n") else len(buf)
        if not has_cr:
            return starts, ends, buf
        cr = np.flatnonzero(buf == 0x0D)
        first_cr = np.searchsorted(cr, starts, side="left")
        hc = (first_cr < len(cr)) & (cr[np.minimum(first_cr, len(cr) - 1)] < ends)
        ends = np.where(hc, cr[np.minimum(first_cr, len(cr) - 1)], ends)
        return starts, ends, buf
    nl = np.flatnonzero(buf == 0x0A)
    starts = np.empty(len(nl) + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    ends = np.empty(len(nl) + 1, dtype=np.int64)
    ends[:-1] = nl
    ends[-1] = len(buf)
    if len(buf) and starts[-1] == len(buf):
        # data ended with a newline -> no dangling final line
        starts, ends = starts[:-1], ends[:-1]
    # chomp at first CR inside each line
    cr = np.flatnonzero(buf == 0x0D)
    if len(cr):
        first_cr = np.searchsorted(cr, starts, side="left")
        has_cr = (first_cr < len(cr)) & (cr[np.minimum(first_cr, len(cr) - 1)] < ends)
        ends = np.where(has_cr, cr[np.minimum(first_cr, len(cr) - 1)], ends)
    return starts, ends, buf


def _gather_padded(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, width: Optional[int] = None
) -> np.ndarray:
    """[B, W] uint8 right-zero-padded gather of variable-length slices."""
    n = len(starts)
    w = int(width if width is not None else (lens.max() if n else 0))
    out = np.zeros((n, max(w, 1)), dtype=np.uint8)[:, :w] if w == 0 else np.zeros((n, w), dtype=np.uint8)
    if n and w:
        col = np.arange(w, dtype=np.int64)
        mask = col[None, :] < lens[:, None]
        idx = starts[:, None] + col[None, :]
        out[mask] = buf[idx[mask]]
    return out


def _line_bytes(buf: np.ndarray, start: int, end: int) -> bytes:
    return buf[start:end].tobytes()


def _parse_numeric_qual_line(
    line: bytes, line_number: int, seq_len: int, out_row: np.ndarray
) -> None:
    """Replicates convert_numeric_quality_score_line (fastx.c:137-167)."""
    pos = 0
    index = 0
    while True:
        m = _STRTOL_RE.match(line, pos)
        if m is None:
            tok = line[pos:].decode("latin-1")
            raise FastxError(
                'Error: invalid quality score data on line %d (quality_tok = "%s"'
                % (line_number, tok)
            )
        value = int(m.group(0))
        if value > MAX_QUALITY_VALUE or value < MIN_QUALITY_VALUE:
            raise FastxError(
                "invalid quality score value (%d) in line %d." % (value, line_number)
            )
        if index < seq_len:
            out_row[index] = value
        index += 1
        pos = m.end()
        if pos >= len(line):
            break
    if index != seq_len:
        raise FastxError(
            "number of quality values (%d) doesn't match number of nucleotides (%d) on line %d"
            % (index, seq_len, line_number)
        )


def parse_counts_from_names(names: StringColumn) -> np.ndarray:
    """get_reads_count for a FASTA batch (fastx.c:475-495).

    The reference takes atoi() of everything after the first '-' in the id
    and uses it when > 0, else 1.
    """
    n = len(names)
    counts = np.ones(n, dtype=np.int32)
    buf, offs = names.buf, names.offs
    dash_rows = np.flatnonzero(
        np.diff(np.searchsorted(np.flatnonzero(buf == ord("-")), offs)) > 0
    )
    for i in dash_rows:
        name = buf[offs[i] : offs[i + 1]].tobytes()
        after = name[name.index(b"-") + 1 :]
        m = _ATOI_RE.match(after)
        if m:
            v = int(m.group(1))
            if v > 0:
                counts[i] = min(v, np.iinfo(np.int32).max)
    return counts


def detect_format(data: bytes, input_name: str, filetype: str) -> bool:
    """First-character format detection (fastx.c:86-116). True => FASTQ."""
    if len(data) == 0:
        raise FastxError("Premature End-Of-File (filename ='%s')" % input_name)
    c = data[:1]
    if c == b">":
        if filetype == FASTQ_ONLY:
            raise FastxError(
                "input file (%s) is FASTA, but only FASTQ input is allowed." % input_name
            )
        return False
    if c == b"@":
        if filetype == FASTA_ONLY:
            raise FastxError(
                "input file (%s) is FASTQ, but only FASTA input is allowed." % input_name
            )
        return True
    raise FastxError(
        "input file (%s) has unknown file format (not FASTA or FASTQ), first character = %c (%d)"
        % (input_name, chr(c[0]), c[0])
    )


def parse(
    data: bytes,
    *,
    filetype: str = FASTA_OR_FASTQ,
    allow_n: bool = True,
    allow_u: bool = False,
    allow_lower: bool = False,
    q_offset: int = 33,
    input_name: str = "-",
    line_number_base: int = 0,
    is_fastq: Optional[bool] = None,
) -> ReadBatch:
    """Parse a complete FASTA/FASTQ byte buffer into a ReadBatch.

    ``line_number_base`` supports chunked streaming: error messages carry
    absolute input line numbers like the reference's input_line_number.
    ``is_fastq`` can be forced when the format was already detected from
    the first chunk of a stream.
    """
    if is_fastq is None:
        is_fastq = detect_format(data, input_name, filetype)
    elif len(data) == 0:
        return _empty_batch(is_fastq)

    starts, ends, buf = _split_lines(data)
    nlines = len(starts)
    lens = ends - starts
    lpr = 4 if is_fastq else 2  # lines per record
    nrec = nlines // lpr

    allowed = _allowed_byte_table(allow_n, allow_u, allow_lower)

    def lineno(line_idx: int) -> int:
        return line_number_base + line_idx + 1

    rem = nlines - nrec * lpr

    def _raise_partial_record_error():
        # the reference reads line-by-line, so a trailing incomplete record
        # is only reported after every complete record parsed cleanly; the
        # partial record's own lines are still validated in order first.
        msgs = {
            1: "Failed to read complete record, missing 2nd line (nucleotides), on line %d\n",
            2: "Failed to read complete record, missing 3rd line (name-2), on line %d\n",
            3: "Failed to read complete record, missing 4th line (quality), on line %d\n",
        }
        h = nrec * lpr
        _check_header_prefix(buf, starts[h], ends[h], is_fastq, allowed, lineno(h))
        if rem >= 2:
            _check_seq_line(buf, starts[h + 1], ends[h + 1], allowed, lineno(h + 1))
        raise FastxError(msgs[rem] % lineno(nrec * lpr + rem))

    if nrec == 0:
        if rem:
            _raise_partial_record_error()
        return _empty_batch(is_fastq)

    hdr_idx = np.arange(nrec) * lpr
    seq_idx = hdr_idx + 1

    # ---- header prefix checks (fastx.c:332-347) ----
    prefix = ord("@") if is_fastq else ord(">")
    hdr_first = np.where(lens[hdr_idx] > 0, buf[starts[hdr_idx].clip(0, len(buf) - 1)], 0)
    bad_hdr = hdr_first != prefix
    # ---- sequence-line checks ----
    seq_lens = lens[seq_idx]
    w = int(seq_lens.max()) if nrec else 0
    seq_starts = np.ascontiguousarray(starts[seq_idx])
    seq_lens_c = np.ascontiguousarray(seq_lens)
    if native.LIB is not None and nrec:
        seq_mat = native.gather_rows(buf, seq_starts, seq_lens_c, w)
        first_invalid = native.validate_rows(
            buf, seq_starts, seq_lens_c, allowed.astype(np.uint8)
        )
        seq_ok = np.ones(nrec, bool)
        if first_invalid >= 0:
            seq_ok[first_invalid] = False
    else:
        seq_mat = _gather_padded(buf, seq_starts, seq_lens_c)
        col0 = np.arange(max(w, 1), dtype=np.int64)[:w]
        in_len0 = col0[None, :] < seq_lens[:, None]
        seq_ok = np.where(in_len0, allowed[seq_mat], True).all(axis=1)
    col = np.arange(max(w, 1), dtype=np.int64)[:w]
    in_len = col[None, :] < seq_lens[:, None]
    empty_seq = seq_lens == 0
    bad_seq = (~seq_ok) | empty_seq

    first_bad_hdr = int(np.argmax(bad_hdr)) if bad_hdr.any() else nrec
    first_bad_seq = int(np.argmax(bad_seq)) if bad_seq.any() else nrec
    if min(first_bad_hdr, first_bad_seq) < nrec:
        if first_bad_hdr <= first_bad_seq:
            i = first_bad_hdr
            _check_header_prefix(
                buf, starts[hdr_idx[i]], ends[hdr_idx[i]], is_fastq, allowed, lineno(hdr_idx[i])
            )
        i = first_bad_seq
        _check_seq_line(
            buf, starts[seq_idx[i]], ends[seq_idx[i]], allowed, lineno(seq_idx[i])
        )

    # ---- bases stay as raw ASCII bytes (already zero-padded) ----
    bases = seq_mat

    # ---- names ----
    name_starts = starts[hdr_idx] + 1  # skip prefix char
    name_lens = (lens[hdr_idx] - 1).clip(min=0)
    names = _column_from_slices(buf, name_starts, name_lens)

    quals = np.zeros_like(bases, dtype=np.int8)
    names2 = None
    qual_ascii = None
    counts = np.ones(nrec, dtype=np.int32)

    if is_fastq:
        n2_idx = hdr_idx + 2
        q_idx = hdr_idx + 3
        n2_starts = starts[n2_idx] + 1
        n2_lens = (lens[n2_idx] - 1).clip(min=0)
        names2 = _column_from_slices(buf, n2_starts, n2_lens)

        q_lens = lens[q_idx]
        qual_ascii = q_lens == seq_lens
        q_starts = np.ascontiguousarray(starts[q_idx])
        ql_eff = np.ascontiguousarray(np.where(qual_ascii, q_lens, 0))
        numeric_rows = np.flatnonzero(~qual_ascii)
        if native.LIB is not None:
            qvals, fb = native.quals_from_ascii(buf, q_starts, ql_eff, w, q_offset)
            first_bad = fb if fb >= 0 else None
        else:
            q_mat = _gather_padded(buf, q_starts, ql_eff, width=w)
            qv = q_mat.astype(np.int32) - q_offset
            in_qlen = in_len & qual_ascii[:, None]
            bad_q = in_qlen & ((qv < MIN_QUALITY_VALUE) | (qv > MAX_QUALITY_VALUE))
            bad_q_rows = bad_q.any(axis=1)
            first_bad = int(np.argmax(bad_q_rows)) if bad_q_rows.any() else None
            qvals = np.where(in_qlen, qv, 0).astype(np.int16)
        for i in numeric_rows:
            if first_bad is not None and i > first_bad:
                break
            _parse_numeric_qual_line(
                _line_bytes(buf, starts[q_idx[i]], ends[q_idx[i]]),
                lineno(q_idx[i]),
                int(seq_lens[i]),
                qvals[i],
            )
        if first_bad is not None:
            i = first_bad
            row = buf[q_starts[i] : q_starts[i] + ql_eff[i]].astype(np.int32)
            badpos = (row - q_offset < MIN_QUALITY_VALUE) | (
                row - q_offset > MAX_QUALITY_VALUE
            )
            j = int(np.argmax(badpos))
            ch = int(row[j])
            raise FastxError(
                "Invalid quality score value (char '%c' ord %d quality value %d) on line %d"
                % (chr(ch), ch, ch - q_offset, lineno(q_idx[i]))
            )
        quals = qvals.astype(np.int8)
    else:
        counts = parse_counts_from_names(names)

    if rem:
        _raise_partial_record_error()

    return ReadBatch(
        bases=bases,
        quals=quals,
        lengths=seq_lens.astype(np.int32),
        counts=counts,
        names=names,
        names2=names2,
        is_fastq=is_fastq,
        qual_ascii=qual_ascii,
    )


class FastqFrame:
    """Raw-line spans of a clean FASTQ chunk (see frame_fastq_fast)."""

    __slots__ = ("buf", "seq_starts", "seq_lens", "qual_starts",
                 "name_starts", "name_lens", "name2_starts", "name2_lens")

    def __init__(self, buf, seq_starts, seq_lens, qual_starts,
                 name_starts, name_lens, name2_starts, name2_lens):
        self.buf = buf
        self.seq_starts = seq_starts
        self.seq_lens = seq_lens
        self.qual_starts = qual_starts
        self.name_starts = name_starts  # after the '@'
        self.name_lens = name_lens
        self.name2_starts = name2_starts  # after the '+'
        self.name2_lens = name2_lens

    def __len__(self):
        return len(self.seq_starts)

    def __iter__(self):  # legacy 4-tuple destructuring
        return iter(
            (self.buf, self.seq_starts, self.seq_lens, self.qual_starts)
        )


def frame_fastq_fast(data: bytes):
    """Vectorized 4-line FASTQ framing for the fused host fast paths
    (stats histogram / collapser dedup / pack / render straight from raw
    line spans).

    Returns a :class:`FastqFrame` when the chunk is clean: complete
    records, '@' header prefixes, and ASCII quality lines (length ==
    sequence length, fastx.c:382-390).  Returns ``None`` whenever
    anything needs the full parser — numeric qualities, framing errors,
    empty chunks — and the caller re-parses with :func:`parse` for the
    reference's exact error text.  Byte validation (sequence alphabet /
    quality value range) is NOT done here; callers run
    ``native.validate_records`` and fall back the same way.
    """
    if not data:
        return None
    starts, ends, buf = _split_lines(data)
    nlines = len(starts)
    if nlines == 0 or nlines % 4:
        return None
    lens = ends - starts
    hdr_starts = starts[0::4]
    hdr_lens = lens[0::4]
    if not ((hdr_lens > 0) & (buf[np.minimum(hdr_starts, len(buf) - 1)]
                              == ord("@"))).all():
        return None
    seq_lens = lens[1::4]
    if not (lens[3::4] == seq_lens).all():
        return None
    n2_lens = lens[2::4]
    # the '+' prefix is implied by position; a record whose 3rd line is
    # empty would be the reference's name2="" case with no '+' — the
    # reference accepts any 3rd line (fastx.c reads it verbatim), but the
    # renderer re-emits '+' + name2, so an empty 3rd line must fall back
    if not (n2_lens > 0).all():
        return None
    return FastqFrame(
        buf,
        np.ascontiguousarray(starts[1::4]),
        np.ascontiguousarray(seq_lens),
        np.ascontiguousarray(starts[3::4]),
        np.ascontiguousarray(hdr_starts + 1),
        np.ascontiguousarray(hdr_lens - 1),
        np.ascontiguousarray(starts[2::4] + 1),
        np.ascontiguousarray(n2_lens - 1),
    )


class FastaFrame:
    """Raw-line spans of a clean single-line FASTA chunk."""

    __slots__ = ("buf", "seq_starts", "seq_lens", "name_starts", "name_lens")

    def __init__(self, buf, seq_starts, seq_lens, name_starts, name_lens):
        self.buf = buf
        self.seq_starts = seq_starts
        self.seq_lens = seq_lens
        self.name_starts = name_starts  # after the '>'
        self.name_lens = name_lens

    def __len__(self):
        return len(self.seq_starts)


def frame_fasta_fast(data: bytes):
    """Vectorized 2-line FASTA framing for the fused host fast paths.

    Returns a :class:`FastaFrame` for clean chunks (complete 2-line
    records, '>' header prefixes); ``None`` sends the caller to the full
    parser — which rejects multi-line FASTA with the reference's friendly
    error (fastx.c:336-342), so a '>'-less even line here must fall back
    rather than be mis-framed.  Byte validation is the caller's job
    (native.validate_records with qual_starts=None).
    """
    if not data:
        return None
    starts, ends, buf = _split_lines(data)
    nlines = len(starts)
    if nlines == 0 or nlines % 2:
        return None
    lens = ends - starts
    hdr_starts = starts[0::2]
    hdr_lens = lens[0::2]
    if not ((hdr_lens > 0) & (buf[np.minimum(hdr_starts, len(buf) - 1)]
                              == ord(">"))).all():
        return None
    return FastaFrame(
        buf,
        np.ascontiguousarray(starts[1::2]),
        np.ascontiguousarray(lens[1::2]),
        np.ascontiguousarray(hdr_starts + 1),
        np.ascontiguousarray(hdr_lens - 1),
    )


def allowed_table_u8(allow_n: bool = True, allow_u: bool = False,
                     allow_lower: bool = False) -> np.ndarray:
    """The reference's allowed_nucleotides table as uint8 (for the native
    raw-line validator)."""
    return _allowed_byte_table(allow_n, allow_u, allow_lower).astype(np.uint8)


def _empty_batch(is_fastq: bool) -> ReadBatch:
    empty = StringColumn(np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64))
    return ReadBatch(
        bases=np.zeros((0, 0), dtype=np.uint8),
        quals=np.zeros((0, 0), dtype=np.int8),
        lengths=np.zeros(0, dtype=np.int32),
        counts=np.zeros(0, dtype=np.int32),
        names=empty,
        names2=empty if is_fastq else None,
        is_fastq=is_fastq,
        qual_ascii=np.zeros(0, dtype=bool) if is_fastq else None,
    )


def _column_from_slices(buf, starts, lens) -> StringColumn:
    n = len(starts)
    if native.LIB is not None and n:
        flat, offs = native.gather_flat(
            buf, np.ascontiguousarray(starts), np.ascontiguousarray(lens)
        )
        return StringColumn(flat, offs)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(offs[-1], dtype=np.uint8)
    if offs[-1]:
        w = int(lens.max())
        col = np.arange(w, dtype=np.int64)
        mask = col[None, :] < lens[:, None]
        out[:] = buf[(starts[:, None] + col[None, :])[mask]]
    return StringColumn(out, offs)


def _check_header_prefix(buf, start, end, is_fastq, allowed, line_no) -> None:
    first = int(buf[start]) if end > start else 0
    want = ord("@") if is_fastq else ord(">")
    if first == want:
        return
    if is_fastq:
        raise FastxError(
            "Invalid input: expecting FASTQ prefix character '@' on line %d. Is this a valid FASTQ file?\n"
            % line_no
        )
    # the reference's friendly multi-line FASTA check (fastx.c:336-342):
    # note an EMPTY line also passes validate_nucleotides_string()
    line = buf[start:end]
    if allowed[line].all():
        raise FastxError(
            "Invalid input: This looks like a multi-line FASTA file.\n"
            "Line %d contains a nucleotides string instead of a '>' prefix.\n"
            "FASTX-Toolkit can't handle multi-line FASTA files.\n"
            "Please use the FASTA-Formatter tool to convert this file into a single-line FASTA.\n"
            % line_no
        )
    raise FastxError(
        "Invalid input: expecting FASTA prefix character '>' on line %d. Is this a valid FASTA file?\n"
        % line_no
    )


def _check_seq_line(buf, start, end, allowed, line_no) -> None:
    if end == start:
        raise FastxError("found empty nucleotide sequence on line %d\n" % line_no)
    line = buf[start:end]
    if not allowed[line].all():
        raise FastxError(
            "found invalid nucleotide sequence (%s) on line %d\n"
            % (line.tobytes().decode("latin-1"), line_no)
        )


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

_NUM_STRS = [b"%d" % v for v in range(MIN_QUALITY_VALUE, MAX_QUALITY_VALUE + 1)]


def render(
    batch: ReadBatch,
    *,
    out_fastq: bool,
    ascii_qual: Union[bool, np.ndarray] = True,
    q_offset: int = 33,
    keep: Optional[np.ndarray] = None,
    mask_thr: Optional[int] = None,
    mask_char: int = ord("N"),
    out: Optional[np.ndarray] = None,
    out_off: int = 0,
):
    """Render a batch to FASTA/FASTQ bytes, matching fastx_write_record
    (fastx.c:440-473) byte for byte.

    ``keep`` drops records during assembly (no host-side select needed);
    ``mask_thr`` applies the fastq_masker byte edit (quality < thr ->
    mask_char) during the copy.  Both are free in the native render loop;
    the numpy fallback applies them as pre-passes.

    ``out``/``out_off`` (native paths only): render into a preallocated
    uint8 arena at the given offset and return the byte count instead of
    a bytes object — streaming callers render a whole lane into one
    buffer with zero intermediate copies.
    """
    n = len(batch)
    if out is not None:
        # validate arena support before the empty-batch early return so a
        # misconfigured caller fails deterministically, not only once
        # data arrives
        if native.LIB is None:
            raise ValueError("out= arena rendering requires the native codec")
        ascii_all = (
            bool(ascii_qual)
            if np.isscalar(ascii_qual)
            else bool(np.asarray(ascii_qual).all())
        )
        if out_fastq and not ascii_all:
            raise ValueError(
                "out= arena rendering is only supported on the native "
                "ASCII-quality fast paths"
            )
    if n == 0:
        return 0 if out is not None else b""
    if native.LIB is None and (keep is not None or mask_thr is not None):
        # fallback: materialize the edits, then render normally
        if mask_thr is not None:
            col = np.arange(batch.bases.shape[1])
            m = (np.asarray(batch.quals) < mask_thr) & (
                col[None, :] < np.asarray(batch.lengths)[:, None]
            )
            batch = ReadBatch(
                bases=np.where(m, np.uint8(mask_char), batch.bases),
                quals=batch.quals, lengths=batch.lengths, counts=batch.counts,
                names=batch.names, names2=batch.names2, is_fastq=batch.is_fastq,
                qual_ascii=batch.qual_ascii,
            )
        if keep is not None:
            kb = np.asarray(keep, bool)
            batch = batch.select(kb)
            if not np.isscalar(ascii_qual):
                ascii_qual = np.asarray(ascii_qual, bool)[kb]
        return render(
            batch, out_fastq=out_fastq, ascii_qual=ascii_qual, q_offset=q_offset
        )
    seq_lens = np.asarray(batch.lengths, dtype=np.int64)
    seq_mat = np.ascontiguousarray(batch.bases, dtype=np.uint8)
    w = seq_mat.shape[1]

    # ---- native fast paths ----
    if native.LIB is not None:
        lens32 = np.ascontiguousarray(batch.lengths, dtype=np.int32)
        if not out_fastq:
            if mask_thr is not None:
                quals8 = np.ascontiguousarray(batch.quals, dtype=np.int8)
                col = np.arange(w)
                m = (quals8 < mask_thr) & (col[None, :] < lens32[:, None])
                seq_mat = np.where(m, np.uint8(mask_char), seq_mat)
            return native.render_fasta(
                seq_mat, lens32, batch.names.buf, batch.names.offs, keep=keep,
                out=out, out_off=out_off,
            )
        ascii_all = (
            bool(ascii_qual) if np.isscalar(ascii_qual) else bool(np.asarray(ascii_qual).all())
        )
        if ascii_all:
            quals8 = np.ascontiguousarray(batch.quals, dtype=np.int8)
            if quals8.shape != seq_mat.shape:
                qq = np.zeros_like(seq_mat, dtype=np.int8)
                cw = min(quals8.shape[1], w)
                qq[:, :cw] = quals8[:, :cw]
                quals8 = qq
            n2 = batch.names2 if batch.names2 is not None else StringColumn(
                np.zeros(0, np.uint8), np.zeros(n + 1, np.int64)
            )
            return native.render_fastq(
                seq_mat, quals8, lens32, batch.names.buf, batch.names.offs,
                n2.buf, n2.offs, q_offset, keep=keep, mask_thr=mask_thr,
                mask_char=mask_char, out=out, out_off=out_off,
            )

    if out is not None:
        raise ValueError(
            "out= arena rendering is only supported on the native "
            "ASCII-quality fast paths"
        )
    if keep is not None or mask_thr is not None:
        # remaining paths (numpy assembly / numeric-qual records) don't
        # fuse the edits; materialize them and re-render
        if mask_thr is not None:
            col = np.arange(batch.bases.shape[1])
            m = (np.asarray(batch.quals) < mask_thr) & (
                col[None, :] < np.asarray(batch.lengths)[:, None]
            )
            batch = ReadBatch(
                bases=np.where(m, np.uint8(mask_char), batch.bases),
                quals=batch.quals, lengths=batch.lengths, counts=batch.counts,
                names=batch.names, names2=batch.names2, is_fastq=batch.is_fastq,
                qual_ascii=batch.qual_ascii,
            )
        if keep is not None:
            kb = np.asarray(keep, bool)
            batch = batch.select(kb)
            if not np.isscalar(ascii_qual):
                ascii_qual = np.asarray(ascii_qual, bool)[kb]
        return render(
            batch, out_fastq=out_fastq, ascii_qual=ascii_qual, q_offset=q_offset
        )

    name_mat, name_lens = batch.names.padded()
    name_lens = name_lens.astype(np.int64)
    nw = name_mat.shape[1]

    if not out_fastq:
        widths = [
            (np.full(n, ord(">"), np.uint8), None, np.ones(n, dtype=np.int64)),
            (name_mat, nw, name_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
            (seq_mat, w, seq_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
        ]
        return _assemble(widths, n)

    # FASTQ
    ascii_arr = (
        np.full(n, bool(ascii_qual)) if np.isscalar(ascii_qual) else np.asarray(ascii_qual, bool)
    )
    name2_mat, name2_lens = (
        batch.names2.padded() if batch.names2 is not None else (np.zeros((n, 0), np.uint8), np.zeros(n, np.int32))
    )
    name2_lens = name2_lens.astype(np.int64)
    quals = np.asarray(batch.quals, dtype=np.int32)

    if ascii_arr.all():
        qual_mat = (quals + q_offset).astype(np.uint8)
        qw = qual_mat.shape[1]
        widths = [
            (np.full(n, ord("@"), np.uint8), None, np.ones(n, dtype=np.int64)),
            (name_mat, nw, name_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
            (seq_mat, w, seq_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
            (np.full(n, ord("+"), np.uint8), None, np.ones(n, dtype=np.int64)),
            (name2_mat, name2_mat.shape[1], name2_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
            (qual_mat, qw, seq_lens),
            (np.full(n, 0x0A, np.uint8), None, np.ones(n, dtype=np.int64)),
        ]
        return _assemble(widths, n)

    # mixed / numeric quality output: per-record slow path (rare;
    # numeric-qual files are a legacy Solexa format)
    parts = []
    names = batch.names
    names2 = batch.names2
    for i in range(n):
        L = int(seq_lens[i])
        parts.append(b"@" + names.get(i) + b"\n")
        parts.append(seq_mat[i, :L].tobytes() + b"\n")
        parts.append(b"+" + (names2.get(i) if names2 is not None else b"") + b"\n")
        if ascii_arr[i]:
            parts.append((quals[i, :L] + q_offset).astype(np.uint8).tobytes() + b"\n")
        else:
            parts.append(
                b" ".join(_NUM_STRS[v - MIN_QUALITY_VALUE] for v in quals[i, :L]) + b"\n"
            )
    return b"".join(parts)


def _assemble(fields, n: int) -> bytes:
    """Assemble per-record variable-width fields into one flat byte string.

    Each field is (data, width, lens): data is [B] (single byte per record,
    width None) or [B, width]; lens gives the per-record used length.
    """
    lens_list = [f[2] for f in fields]
    rec_lens = np.add.reduce(lens_list)
    total_w = int(rec_lens.max())
    out = np.zeros((n, total_w), dtype=np.uint8)
    col = np.arange(total_w, dtype=np.int64)
    offset = np.zeros(n, dtype=np.int64)
    for data, width, flens in fields:
        if width is None:
            out[np.arange(n), offset] = data
        else:
            if width:
                fcol = np.arange(width, dtype=np.int64)
                src_mask = fcol[None, :] < flens[:, None]
                dst_mask = (col[None, :] >= offset[:, None]) & (
                    col[None, :] < (offset + flens)[:, None]
                )
                out[dst_mask] = data[src_mask]
        offset = offset + flens
    mask = col[None, :] < rec_lens[:, None]
    return out[mask].tobytes()

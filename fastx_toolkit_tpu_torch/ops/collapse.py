"""fastx_collapser's dedup as a device-side sort + segment reduction.

Counterpart of ``fastx_toolkit_tpu/ops/collapse.py`` (FASTX-Toolkit's
``fastx_collapser.cpp:112-122``: a hash map sequence -> reads count,
printed in descending-count order renamed ``>rank-count``).  The
deterministic contract is the reference's: count descending, ties broken
by first appearance in the input (ascending).

Device algorithm: each read's bytes packed into big-endian 32-bit words
(:func:`pack_words`: word order is byte order, PAD=0 sorts
shortest-first), a sort that makes equal sequences contiguous, segment
boundaries, then segment sums of the counts and segment minima of the
first appearances.  Two forms with identical segments:

* :func:`collapse` — the exact form: W + 1 stable argsorts (the
  reference's ``jnp.lexsort``), boundaries from the sorted words;
* :func:`collapse_hashed` — the reference's hash-prefix form: one sort by
  two 32-bit rolling hashes and the first appearance, boundaries from
  material carried through the sort (the first two words and a second
  hash family), with a sort-hash collision detected and reported so that
  :func:`collapse_batch` re-runs the exact form.

The 32-bit words and hashes are held as non-negative int64 (torch has few
uint32 ops): every multiply and add is reduced mod 2^32, and ``>>`` acts
on the masked value, so it is the logical shift of the uint32 arithmetic.
The XLA sorts of the reference become ``torch.sort``/``torch.argsort``
(plain torch ops: the JAX package leaves them to XLA, no Pallas kernel).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def pack_words(bases: np.ndarray) -> np.ndarray:
    """uint8 [B, L] -> uint32 [B, ceil(L/4)] big-endian packed words."""
    B, L = bases.shape
    L4 = -(-L // 4) * 4
    if L4 != L:
        bases = np.pad(bases, ((0, 0), (0, L4 - L)))
    return bases.reshape(B, L4 // 4, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )


def _u32(words):
    """The words' low 32 bits as non-negative int64 (uint32 values or
    their int32 bit patterns alike)."""
    return words.to(torch.int64) & _M32


def _mul32(a, m: int):
    """``a * m mod 2^32`` for ``a`` int64 in [0, 2^32) and a Python int
    ``m`` < 2^32, in halves so no int64 product overflows."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _M32


def _segments(head, counts, first, B):
    """Segment ids of the sorted rows, per-segment count sums and
    first-appearance minima (valid at the first ``head.sum()`` slots)."""
    seg_id = (torch.cumsum(head, 0) - 1).to(torch.int32)
    seg_counts = torch.zeros(B, dtype=counts.dtype, device=counts.device)
    seg_counts.index_add_(0, seg_id, counts)
    seg_first = torch.full((B,), _INT32_MAX, dtype=torch.int32,
                           device=first.device)
    seg_first.scatter_reduce_(0, seg_id.long(), first.to(torch.int32),
                              "amin", include_self=True)
    return seg_id, seg_counts, seg_first


def collapse(words, counts, first_idx):
    """Device dedup, exact form.

    ``words`` [B, W] (the uint32 words, or their int32 bit patterns),
    ``counts`` int32 [B], ``first_idx`` int32 [B] (original positions for
    the first-appearance tie-break), all on one device.

    Returns ``(perm, head, seg_id, seg_counts, seg_first)``: ``perm``
    sorts rows lexicographically (first_idx the least significant key),
    ``head`` marks segment heads in sorted order, ``seg_counts`` and
    ``seg_first`` are per-segment totals valid at the first
    ``head.sum()`` slots.
    """
    wu = _u32(words)
    B, W = wu.shape
    # least significant key first: first_idx, then word W-1 ... word 0
    perm = torch.argsort(first_idx, stable=True)
    for w in range(W - 1, -1, -1):
        perm = perm[torch.argsort(wu[perm, w], stable=True)]
    sw = wu[perm]
    head = torch.ones(B, dtype=torch.bool, device=wu.device)
    head[1:] = (sw[1:] != sw[:-1]).any(dim=1)
    seg_id, seg_counts, seg_first = _segments(head, counts[perm],
                                              first_idx[perm], B)
    return perm, head, seg_id, seg_counts, seg_first


def rolling_hashes(words):
    """The four 32-bit rolling hashes of each row's words (multiply-add
    with xorshift mixing; ``h1``/``h2`` are the sort keys, ``h3``/``h4``
    the carried second family), as non-negative int64 [B]."""
    wu = _u32(words)
    B, W = wu.shape
    full = lambda v: torch.full((B,), v, dtype=torch.int64,  # noqa: E731
                                device=wu.device)
    h1, h2 = full(0x811C9DC5), full(0x9E3779B9)
    h3, h4 = full(0xC2B2AE35), full(0x27D4EB2F)
    for w in range(W):
        col = wu[:, w]
        h1 = (_mul32(h1, 0x01000193) + col) & _M32
        h1 = h1 ^ (h1 >> 15)
        h2 = (_mul32(h2, 0x85EBCA6B) + (col ^ ((w * 0x9E3779B9) & _M32))) & _M32
        h2 = h2 ^ (h2 >> 13)
        h3 = (_mul32(h3, 0x9E3779B1) + (col ^ ((w * 0x632BE5AB) & _M32))) & _M32
        h3 = h3 ^ (h3 >> 16)
        h4 = (_mul32(h4, 0x2545F491) + col) & _M32
        h4 = h4 ^ (h4 >> 11)
    return h1, h2, h3, h4


def sort_by_hash(h1, h2, first_idx, *payload):
    """The reference's ``lax.sort((h1, h2, first_idx, *payload),
    num_keys=3)``: rows ordered by (h1, h2, first_idx), each compared as
    unsigned, the payload columns carried along.  A stable sort by
    ``first_idx``, then a stable sort by one int64 key
    ``((h1 - 2^31) << 32) + h2``, monotone in the unsigned pair."""
    perm = torch.argsort(first_idx, stable=True)
    key = ((h1 - 2**31) << 32) + h2
    perm = perm[torch.argsort(key[perm], stable=True)]
    return tuple(c[perm] for c in (h1, h2, first_idx) + payload)


def collapse_hashed(words, counts, first_idx, weak_hash: bool = False,
                    unit_counts: bool = False):
    """:func:`collapse` with a hash-prefix sort: rows ordered by the two
    sort hashes and ``first_idx`` (every caller passes unique indices, so
    the order is deterministic), segment boundaries from the material
    carried through the sort (the first two words, ``h3``, ``h4``).

    * equal sequences never split (all carried material is a function of
      the words);
    * different adjacent sequences merge only if they agree on the sort
      hashes, the prefix words and the second family;
    * a sort-hash collision between different rows (equal ``(h1, h2)``,
      different carried material: the case that can interleave two
      groups) is detected and returned as ``collision``; callers re-run
      the exact :func:`collapse` (:func:`collapse_batch` does).

    ``weak_hash`` (test hook) sets both sort hashes to 0 so the collision
    path is exercised (the second family stays real).  ``unit_counts``:
    the caller guarantees ``counts == 1`` everywhere (plain FASTQ), so
    segment counts are segment sizes.

    Returns ``(None, head, seg_id, seg_counts, seg_first, collision)``,
    ``collision`` a 0-dim bool tensor.
    """
    wu = _u32(words)
    B, W = wu.shape
    h1, h2, h3, h4 = rolling_hashes(wu)
    zero = torch.zeros(B, dtype=torch.int64, device=wu.device)
    if weak_hash:
        h1 = h2 = zero
    w0 = wu[:, 0] if W > 0 else zero
    w1 = wu[:, 1] if W > 1 else zero
    payload = (w0, w1, h3, h4) if unit_counts else (counts, w0, w1, h3, h4)
    sorted_ops = sort_by_hash(h1, h2, first_idx, *payload)
    sh1, sh2, sfirst = sorted_ops[:3]
    scnt = (torch.ones(B, dtype=counts.dtype, device=counts.device)
            if unit_counts else sorted_ops[3])
    sw0, sw1, sh3, sh4 = sorted_ops[-4:]
    neq = ((sh1[1:] != sh1[:-1]) | (sh2[1:] != sh2[:-1])
           | (sw0[1:] != sw0[:-1]) | (sw1[1:] != sw1[:-1])
           | (sh3[1:] != sh3[:-1]) | (sh4[1:] != sh4[:-1]))
    head = torch.ones(B, dtype=torch.bool, device=wu.device)
    head[1:] = neq
    samehash = (sh1[1:] == sh1[:-1]) & (sh2[1:] == sh2[:-1])
    collision = (samehash & neq).any()
    seg_id, seg_counts, seg_first = _segments(head, scnt, sfirst, B)
    return None, head, seg_id, seg_counts, seg_first, collision


def collapse_batch(bases: np.ndarray, counts: np.ndarray, device=None):
    """Host wrapper: ``(uniq_row_indices, uniq_counts, uniq_first)`` where
    ``uniq_row_indices`` point into the original batch (the
    first-appearance representative of each distinct sequence).  The
    dedup runs on ``device`` (default: ``device.resolve_device()``);
    ``FASTX_COLLAPSE_EXACT`` routes it through the exact form,
    ``FASTX_COLLAPSE_WEAK_HASH`` degrades the sort hashes (test hook)."""
    from ..device import resolve_device

    B = bases.shape[0]
    if B == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    if device is None:
        device = resolve_device()
    words_np = pack_words(np.asarray(bases, dtype=np.uint8))
    counts_np = np.asarray(counts, np.int32)
    # the words cross as their int32 bit patterns: 4 bytes a word
    words = torch.from_numpy(words_np.view(np.int32)).to(device)
    cnt = torch.from_numpy(counts_np).to(device)
    first_idx = torch.arange(B, dtype=torch.int32, device=device)
    if os.environ.get("FASTX_COLLAPSE_EXACT"):
        res = collapse(words, cnt, first_idx) + (False,)
    else:
        weak = bool(os.environ.get("FASTX_COLLAPSE_WEAK_HASH"))
        res = collapse_hashed(words, cnt, first_idx, weak_hash=weak,
                              unit_counts=bool((counts_np == 1).all()))
    if bool(res[5]):  # sort-hash collision: exact re-run
        res = collapse(words, cnt, first_idx)
    head, _seg_id, seg_counts, seg_first = res[1:5]
    nseg = int(head.sum())
    uniq_first = seg_first[:nseg].cpu().numpy()
    uniq_counts = seg_counts[:nseg].cpu().numpy()
    return uniq_first.astype(np.int64), uniq_counts.astype(np.int64), uniq_first


def final_order(uniq_counts: np.ndarray, uniq_first: np.ndarray) -> np.ndarray:
    """Output order: count descending, first-appearance ascending."""
    return np.lexsort((uniq_first, -uniq_counts.astype(np.int64)))


def _dec_digits(x: np.ndarray):
    """Vectorized base-10: -> (digits uint8 [U, D] right-aligned with
    leading zeros, ndig int64 [U])."""
    x = np.asarray(x, np.int64)
    U = len(x)
    maxv = int(x.max()) if U else 0
    D = max(1, len(str(max(maxv, 0))))
    digs = np.empty((U, D), np.uint8)
    v = x.copy()
    for d in range(D - 1, -1, -1):
        digs[:, d] = (v % 10) + 48
        v //= 10
    if D > 1:
        p10 = 10 ** np.arange(1, D, dtype=np.int64)
        ndig = 1 + (x[:, None] >= p10[None, :]).sum(axis=1)
    else:
        ndig = np.ones(U, np.int64)
    return digs, ndig


def ordinal_column(start: int, n: int):
    """Sequential decimal ids ``start+1 .. start+n`` as a StringColumn's
    innards (flat uint8 buffer, int64 offsets) — the vectorized form of
    ``[b"%d" % (start + i + 1) ...]`` used by fastx_renamer COUNT mode,
    the uncollapser, and fastq_to_fasta -r."""
    vals = np.arange(start + 1, start + n + 1, dtype=np.int64)
    digs, ndig = _dec_digits(vals)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(ndig, out=offs[1:])
    flat = np.empty(int(offs[-1]), np.uint8)
    rows = np.arange(n, dtype=np.int64)
    D = digs.shape[1]
    for k in range(D):
        m = k < ndig
        flat[offs[:-1][m] + k] = digs[rows[m], D - ndig[m] + k]
    return flat, offs


def rank_count_column(counts: np.ndarray):
    """The collapser's ``rank-count`` id column, vectorized (the Python
    b"%d-%d" loop is ~2 s per million records; this is ~20 numpy passes).

    counts are in output order; ranks are 1-based positions.  Returns
    (flat uint8 buffer, int64 offsets [U+1]) — a StringColumn's innards.
    """
    counts = np.asarray(counts, np.int64)
    U = len(counts)
    ranks = np.arange(1, U + 1, dtype=np.int64)
    dr, nr = _dec_digits(ranks)
    dc, nc = _dec_digits(counts)
    lens = nr + 1 + nc
    offs = np.zeros(U + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = np.empty(int(offs[-1]), np.uint8)
    rows = np.arange(U, dtype=np.int64)
    Dr = dr.shape[1]
    for k in range(Dr):  # k-th significant digit of the rank
        m = k < nr
        flat[offs[:-1][m] + k] = dr[rows[m], Dr - nr[m] + k]
    flat[offs[:-1] + nr] = ord("-")
    Dc = dc.shape[1]
    base = offs[:-1] + nr + 1
    for k in range(Dc):
        m = k < nc
        flat[base[m] + k] = dc[rows[m], Dc - nc[m] + k]
    return flat, offs

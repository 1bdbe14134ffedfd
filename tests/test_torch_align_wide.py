"""The port's wide packed DP (K3's route) and unpacked DP (K4's route)
against the JAX package's, exactly, on all 9 fields.

* ``kernels/align_cuda.py::align_batch_packed`` outside K1's bounds
  (adapters of 32-72 bases, reads over 511 bp) on CPU tensors (its plain
  path) vs the reference ``align_batch_pallas_packed(interpret=True)``
  (the two-plane kernel) and, at the other shapes, vs the reference
  ``align_batch(tie_flag=True)``, which the JAX tests hold equal to both
  kernels (interpret mode is slow);
* ``kernels/align_unpacked_cuda.py::align_batch_unpacked`` on CPU
  tensors vs the reference ``align_batch_pallas(interpret=True)`` on
  ACGTN, lowercase and U bytes, and at H=99 vs ``align_batch``;
* a numpy model of K3's schedule in ``csrc/align_packed.cu`` (a lane
  group per read, a wavefront across the lanes, exactly the values the
  kernel hands from lane to lane) vs the port's plain ``align_batch`` and
  the reference ``align_batch(tie_flag=True)``, at every lane count the
  kernel instantiates.

Results are integers: every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.kernels import align as ref_align
from fastx_toolkit_tpu_torch.kernels import align_cuda
from fastx_toolkit_tpu_torch.kernels.align_unpacked_cuda import (
    align_batch_unpacked,
)

FIELDS = (
    "matches", "mismatches", "gaps", "neutral", "query_start", "query_end",
    "target_start", "target_end", "tie_fragile",
)
ALPHA = np.frombuffer(b"ACGTN", np.uint8)
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


def _adapter(rng, H, with_n):
    ad = bytearray((TRUSEQ * 3)[:H])
    if with_n:
        for j in rng.integers(0, H, 3):
            ad[j] = ord("N")
    return bytes(ad)


def _reads(rng, B, L, adapter, alpha=ALPHA, n_frac=0.05):
    """Reads over ``alpha`` with noisy copies of ``adapter`` spiked in and
    lengths 0..L; bytes beyond a read are 0 (PAD)."""
    if len(alpha) == 5 and bytes(alpha) == b"ACGTN":
        p = [(1 - n_frac) / 4] * 4 + [n_frac]
        bases = rng.choice(alpha, size=(B, L), p=p)
    else:
        bases = rng.choice(alpha, size=(B, L))
    for i in range(0, B, 2):
        pos = int(rng.integers(0, max(1, L - 10)))
        ad = bytearray(adapter)
        for _ in range(int(rng.integers(0, 3))):
            ad[int(rng.integers(0, len(ad)))] = int(rng.choice(alpha))
        seg = np.frombuffer(bytes(ad), np.uint8)[:L - pos]
        bases[i, pos:pos + len(seg)] = seg
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return bases, lengths


def _packed_operands(bases, adapter):
    """The reference's packed word layout (pack_batch2 + _words_T)."""
    from fastx_toolkit_tpu.engine.pipeline import (
        PipelineConfig,
        _words_T,
        pack_batch2,
    )

    B, L = bases.shape
    b_for_pack = np.where(bases == 0, ord("A"), bases).astype(np.uint8)
    b2, planes = pack_batch2(b_for_pack, np.full((B, L), 30, np.int8),
                             PipelineConfig(adapter=adapter), n_plane=True)
    L32 = -(-L // 32) * 32
    b2w = np.asarray(_words_T(b2, L32 // 4))
    nmw = np.asarray(_words_T(planes[:, 0], L32 // 8))
    return b2w, nmw


def _port_packed(b2w, nmw, lengths, adapter, L):
    return align_cuda.align_batch_packed(
        torch.tensor(b2w.view(np.int32)),
        None if nmw is None else torch.tensor(nmw.view(np.int32)),
        torch.from_numpy(lengths), adapter, L=L, tie_flag=True)


def _assert_equal(got, ref):
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_wide_packed_matches_reference_two_plane_kernel(monkeypatch):
    """H=33 with the N plane through the reference's two-plane Pallas
    kernel in interpret mode (the P12 bounds fail, so it takes K3)."""
    from fastx_toolkit_tpu.kernels.align_pallas import (
        align_batch_pallas_packed,
    )

    monkeypatch.delenv("FASTX_TPU_NO_P12", raising=False)
    rng = np.random.default_rng(33)
    B, L = 32, 64
    bases, lengths = _reads(rng, B, L, TRUSEQ, n_frac=0.1)
    b2w, nmw = _packed_operands(bases, TRUSEQ)
    assert not align_cuda.packed12_ok(L, len(TRUSEQ))
    assert align_cuda.packed_wide_ok(L, len(TRUSEQ))
    ref = align_batch_pallas_packed(b2w, nmw, lengths, TRUSEQ, L=L, tile_b=B,
                                    interpret=True, tie_flag=True)
    _assert_equal(_port_packed(b2w, nmw, lengths, TRUSEQ, L), ref)


@pytest.mark.parametrize("H,L,with_nm,n_adapter", [
    (32, 64, True, False),
    (32, 96, False, False),
    (33, 64, False, False),
    (33, 96, True, True),
    (40, 64, True, False),
    (40, 96, False, True),
    (72, 64, False, False),
    (72, 96, True, True),
    (40, 600, True, False),       # L > 511 with a wide adapter
])
def test_wide_packed_matches_reference(H, L, with_nm, n_adapter):
    rng = np.random.default_rng(1000 * H + L)
    adapter = _adapter(rng, H, n_adapter)
    bases, lengths = _reads(rng, 24, L, adapter,
                            n_frac=0.08 if with_nm else 0.0)
    if not with_nm:
        bases[bases == ord("N")] = ord("A")
    b2w, nmw = _packed_operands(bases, adapter)
    if not with_nm:
        nmw = None  # N-free: no plane shipped
    ref = ref_align.align_batch(np.where(bases == 0, ord("A"), bases),
                                lengths, adapter, tie_flag=True)
    got = _port_packed(b2w, nmw, lengths, adapter, L)
    _assert_equal(got, ref)
    if with_nm and n_adapter:
        assert np.asarray(ref["tie_fragile"]).any()


def test_wide_packed_gate():
    assert align_cuda.packed_wide_ok(600, 17)
    assert align_cuda.packed_wide_ok(100, 72)
    assert not align_cuda.packed_wide_ok(100, 73)        # H_pad 80 > 72
    assert not align_cuda.packed_wide_ok(32700, 40)      # gap field bound
    b2w = torch.zeros((8, 4), dtype=torch.int32)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bounds"):
        align_cuda.align_batch_packed(b2w, None, lengths, b"A" * 73, L=100)


@pytest.mark.parametrize("adapter,alphabet", [
    (b"A", b"ACGTN"),
    (b"CCTTAAGG", b"ACGTNacgtn"),
    (b"TGGAATTCTCGGGTGCCAAGG", b"ACGTN"),
    (b"tggNattcUcgggtgccaagg", b"ACGTNacgtnUu"),
])
def test_unpacked_matches_reference_kernel(adapter, alphabet):
    """K4's route vs the reference unpacked Pallas kernel (interpret
    mode), any bytes: lowercase never matches uppercase, U is a letter
    like any other, only the byte N is neutral."""
    from fastx_toolkit_tpu.kernels.align_pallas import align_batch_pallas

    rng = np.random.default_rng(len(adapter) + len(alphabet))
    B, L = 64, 48
    bases, lengths = _reads(rng, B, L, adapter,
                            alpha=np.frombuffer(alphabet, np.uint8))
    ref = align_batch_pallas(bases, lengths, adapter, tile_b=B,
                             interpret=True, tie_flag=True)
    got = align_batch_unpacked(torch.from_numpy(bases),
                               torch.from_numpy(lengths), adapter,
                               tie_flag=True)
    _assert_equal(got, ref)


def test_unpacked_h99_matches_reference():
    adapter = b"tggaattcUcgggtgccaagg" * 4 + b"ACGNNUuuuACGTNa"
    assert len(adapter) == 99
    rng = np.random.default_rng(99)
    bases, lengths = _reads(rng, 48, 200, adapter,
                            alpha=np.frombuffer(b"ACGTNacgtnUu", np.uint8))
    ref = ref_align.align_batch(bases, lengths, adapter, tie_flag=True)
    got = align_batch_unpacked(torch.from_numpy(bases),
                               torch.from_numpy(lengths), adapter,
                               tie_flag=True)
    _assert_equal(got, ref)


def test_unpacked_checks_operands():
    with pytest.raises(ValueError, match="uint8"):
        align_batch_unpacked(torch.zeros((2, 4), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32), b"ACGT")
    with pytest.raises(ValueError, match="lengths"):
        align_batch_unpacked(torch.zeros((2, 4), dtype=torch.uint8),
                             torch.zeros(3, dtype=torch.int32), b"ACGT")


# --- K3's schedule, modelled in numpy ---------------------------------------

_GAP = -50
_NEG, _NEG_BEST = -1000000, -10000000
_FLAG, _G1, _TS = 1 << 31, 1 << 16, 24
_RISKY = _FLAG | (0xFF << 16)
_CODES = {65: 0, 67: 1, 71: 2, 84: 3, 78: 4}


def _nm(w1):
    return (w1 >> 16) & 0xFF


def _border(y):
    return np.where(y <= 3, 0, _GAP * (y - 3))


def _prmt(lo, hi, sel):
    """PTX ``prmt.b32`` (default mode) on int64 arrays holding uint32s."""
    src = [(lo >> (8 * k)) & 0xFF for k in range(4)] + \
          [(hi >> (8 * k)) & 0xFF for k in range(4)]
    out = 0
    for k in range(4):
        nib = (sel >> (4 * k)) & 15
        byte = np.choose(nib & 7, src)
        byte = np.where(nib & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out = out | (byte << (8 * k))
    return out


def _i32(v):
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _emulate_k3(b2w, nmw, lengths, adapter, L, tie):
    """``csrc/align_packed.cu`` step by step in numpy: ``k3_lanes(H)``
    lanes a read, ``K3_ROWS`` rows a lane, lane ``j`` on column ``s - j``
    at step ``s``, the deltas and counter shifts from the column's byte
    tables by ``prmt``, padding rows unmasked, the column max taken over
    a lane's rows and merged behind the rows above; after each step every
    lane takes from the lane above exactly what the kernel shuffles (its
    last row's score, W1, W2, the column max's score, W1, W2 and the
    packed row / tied count / risky / code / N word); lane 0's row above
    is the row-0 border.  Arrays are ``[lane, read]``; the loop runs to the batch's
    longest read (the kernel stops at its warp's; the extra steps find
    every lane idle).  Returns the kernel's 9 output fields."""
    K, H = align_cuda.K3_ROWS, len(adapter)
    G = align_cuda.k3_lanes(H)
    b2w = b2w.view(np.uint32).astype(np.int64)
    nmw = None if nmw is None else nmw.view(np.uint32).astype(np.int64)
    B = b2w.shape[1]
    lane = np.arange(G)[:, None]
    y0 = lane * K
    ln = np.clip(lengths, 0, L)[None, :]
    ys = y0 + np.arange(K)[None, :]                                   # [G, K]
    r = np.array([_CODES[c] for c in adapter] + [5] * (G * K - H))[ys]
    sel = np.where(r < 5, r | (r + 8) << 4 | (r + 8) << 8 | (r + 8) << 12,
                   0x7777)
    sc = np.repeat(_border(ys)[:, :, None], B, 2)         # pseudo column -1
    w1 = np.repeat(((ys + 1) << _TS)[:, :, None], B, 2)
    w2 = np.zeros((G, K, B), np.int64)
    zero = np.zeros((G, B), np.int64)
    in_sc, in_w1, in_w2 = zero.copy(), zero.copy(), zero.copy()
    pv_sc = np.repeat(_border(y0 - 1), B, 1)
    pv_w1 = np.repeat(y0 << _TS, B, 1)
    pv_w2 = zero.copy()
    in_cmax, in_cw1, in_cw2, in_pk = (zero.copy() for _ in range(4))
    best = np.full(B, _NEG_BEST, np.int64)
    bw1, bw2, bx, by = (np.zeros(B, np.int64) for _ in range(4))
    bfl = np.zeros(B, bool)
    wb, wn = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for s in range(int(ln.max(initial=0)) + G - 1):
        x = s - lane
        act = (x >= 0) & (x < ln)                                     # [G, B]
        # lane 0 reads column s from the packed words
        if s % 16 == 0 and s < L:
            wb = np.where(act[0], b2w[s >> 4], wb)
        if nmw is not None and s % 32 == 0 and s < L:
            wn = np.where(act[0], nmw[s >> 5], wn)
        code = (in_pk >> 15) & 3
        code[0] = (wb >> (8 * ((s >> 2) & 3) + 6 - 2 * (s & 3))) & 3
        qn = ((in_pk >> 17) & 1).astype(bool) & (nmw is not None)
        qn[0] = (nmw is not None) & (
            ((wn >> (8 * ((s >> 3) & 3) + 7 - (s & 7))) & 1) == 1)
        pv_sc[0], pv_w1[0], pv_w2[0] = 0, 0, s  # lane 0: the row-0 border
        in_sc[0], in_w1[0], in_w2[0] = 0, 0, s
        cmax, cw1, cw2 = in_cmax.copy(), in_cw1.copy(), in_cw2.copy()
        cby, ccnt = in_pk & 127, (in_pk >> 7) & 127
        cany = tie & (((in_pk >> 14) & 1) == 1)
        hit = 8 * code
        d_lo = np.where(qn, 0x01010101, 0xF6F6F6F6 ^ (0xFC << hit))
        d_hi = np.where(qn, 0x80000000, 0x80000001)
        s_lo = np.where(qn, 0x10101010, 0x08080808 ^ (0x08 << hit))
        s_hi = 0x10
        up_sc, up_w1, up_w2 = pv_sc, pv_w1, pv_w2
        run_sc, run_w1, run_w2 = in_sc, in_w1, in_w2
        xr = x + 3 - y0
        for i in range(K):
            delta = _i32(_prmt(d_lo, d_hi, sel[:, i:i + 1]))
            inc = 1 << _prmt(s_lo, s_hi, sel[:, i:i + 1])
            p_sc, p_w1, p_w2 = sc[:, i].copy(), w1[:, i].copy(), w2[:, i].copy()
            ul_sc, ul_w1, ul_w2 = up_sc + delta, up_w1 + inc, up_w2
            assert ul_sc.min() >= -(1 << 31)  # int32 never wraps
            left_sc = np.where(xr < i, _NEG, p_sc + _GAP)
            left_w1, left_w2 = p_w1, p_w2 + _G1
            lw = left_sc > ul_sc
            e_sc = np.where(lw, left_sc, ul_sc)
            e_ul = ~lw
            e_w1 = np.where(lw, left_w1, ul_w1)
            e_w2 = np.where(lw, left_w2, ul_w2)
            if tie:
                t1 = (left_sc == ul_sc) & ((_nm(ul_w1) + _nm(left_w1) > 0)
                                           | ((ul_w1 | left_w1) & _FLAG != 0))
                e_w1 = np.where(t1, e_w1 | _FLAG, e_w1)
            chain_sc = run_sc + _GAP
            ywins = (e_sc > chain_sc) | ((e_sc == chain_sc) & e_ul)
            c_sc = np.where(ywins, e_sc, chain_sc)
            c_w1 = np.where(ywins, e_w1, run_w1)
            c_w2 = np.where(ywins, e_w2, run_w2 + _G1)
            if tie:
                ctie = (e_sc == chain_sc) & ((_nm(run_w1) + _nm(e_w1) > 0)
                                             | ((run_w1 | e_w1) & _FLAG != 0))
                c_w1 = np.where(ctie, c_w1 | _FLAG, c_w1)
                if i == 0:  # a winning border-up move: the beaten move's bit
                    c_w1[0] = np.where(ywins[0], c_w1[0], e_w1[0] & _FLAG)
            up_sc, up_w1, up_w2 = p_sc, p_w1, p_w2
            sc[:, i] = np.where(act, c_sc, p_sc)
            w1[:, i] = np.where(act, c_w1, p_w1)
            w2[:, i] = np.where(act, c_w2, p_w2)
            run_sc, run_w1, run_w2 = c_sc, c_w1, c_w2
        # the lane's column max over its rows, padding rows included, then
        # merged behind the rows above (lane 0 starts it)
        m = sc.max(axis=1)
        hits = sc == m[:, None]
        mby = hits.argmax(axis=1)
        pick = np.take_along_axis
        m1 = pick(w1, mby[:, None], 1)[:, 0]
        m2 = pick(w2, mby[:, None], 1)[:, 0]
        mcnt = hits.sum(axis=1)
        mrisky = tie & ((np.bitwise_or.reduce(np.where(hits, w1, 0), axis=1)
                         & _RISKY) != 0)
        gt = act & ((lane == 0) | (m > cmax))
        same = act & ~gt & (m == cmax)
        cmax = np.where(gt, m, cmax)
        cby = np.where(gt, y0 + mby, cby)
        cw1 = np.where(gt, m1, cw1)
        cw2 = np.where(gt, m2, cw2)
        ccnt = np.where(gt, mcnt, np.where(same, ccnt + mcnt, ccnt))
        cany = np.where(gt, mrisky, cany | (same & mrisky))
        pv_sc = np.where(act, in_sc, pv_sc)
        pv_w1 = np.where(act, in_w1, pv_w1)
        pv_w2 = np.where(act, in_w2, pv_w2)
        # the last lane folds the column max into the read's best
        a, m, c1 = act[-1], cmax[-1], cw1[-1]
        improve = a & (m > best)
        if tie:
            cfl = c1 & _FLAG != 0
            t5 = (ccnt[-1] > 1) & cany[-1]
            t4 = a & (m == best) & ((_nm(c1) + _nm(bw1) > 0) | cfl | bfl)
            bfl = np.where(improve, cfl | t5, bfl) | t4
        best = np.where(improve, m, best)
        bw1 = np.where(improve, c1, bw1)
        bw2 = np.where(improve, cw2[-1], bw2)
        bx = np.where(improve, s - (G - 1), bx)
        by = np.where(improve, cby[-1], by)
        # the hand-off to the lane below (__shfl_up_sync, width G)
        pk = (cby | (ccnt << 7) | (cany.astype(np.int64) << 14)
              | (code << 15) | (qn.astype(np.int64) << 17))
        down = np.r_[0, np.arange(G - 1)]
        in_sc, in_w1, in_w2 = sc[down, K - 1], w1[down, K - 1], w2[down, K - 1]
        in_cmax, in_cw1, in_cw2, in_pk = (v[down] for v in (cmax, cw1, cw2, pk))
    return {"matches": bw1 & 0xFF, "mismatches": (bw1 >> 8) & 0xFF,
            "gaps": bw2 >> 16, "neutral": (bw1 >> 16) & 0xFF,
            "query_start": bw2 & 0xFFFF, "query_end": bx,
            "target_start": (bw1 >> _TS) & 0x7F, "target_end": by,
            "tie_fragile": bfl}


@pytest.mark.parametrize("H", [1, 9, 10, 18, 19, 31, 32, 33, 36, 37, 64, 72])
def test_k3_schedule_model_matches_reference(H):
    """The numpy model of K3's wavefront, at every lane count the kernel
    instantiates (H at each boundary of 9 rows a lane), with and without
    the N plane and the flags, equals the port's plain ``align_batch`` and
    the JAX package's ``align_batch(tie_flag=True)`` field by field on
    adversarial reads: Ns, N adapter bases, spiked adapters that tie, and
    lengths of 0, 1, below the lane count and exactly L."""
    from fastx_toolkit_tpu_torch.kernels.align import align_batch

    rng = np.random.default_rng(7000 + H)
    B, L = 64, 80
    G = align_cuda.k3_lanes(H)
    adapter = _adapter(rng, H, with_n=H % 2 == 1)
    bases, lengths = _reads(rng, B, L, adapter, n_frac=0.1)
    lengths[:5] = [0, 1, max(0, G - 1), L, L]
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    free = np.where(bases == ord("N"), ord("A"), bases)   # no N plane
    both = np.concatenate([bases, free])
    ascii_ = np.where(both == 0, ord("A"), both)
    ref = ref_align.align_batch(ascii_, np.concatenate([lengths, lengths]),
                                adapter, tie_flag=True)
    port = align_batch(torch.from_numpy(ascii_),
                       torch.from_numpy(np.concatenate([lengths, lengths])),
                       adapter, tie_flag=True)
    for half, bs, with_nm in ((slice(0, B), bases, True),
                              (slice(B, 2 * B), free, False)):
        b2w, nmw = _packed_operands(bs, adapter)
        for tie in (True, False):
            got = _emulate_k3(b2w, nmw if with_nm else None, lengths,
                              adapter, L, tie)
            for k in FIELDS if tie else FIELDS[:8]:
                want = np.asarray(ref[k])[half]
                np.testing.assert_array_equal(
                    got[k], want, err_msg="%s nm=%s tie=%s" % (k, with_nm, tie))
                np.testing.assert_array_equal(
                    port[k].numpy()[half], want, err_msg=k)
    assert G == {1: 1, 9: 1, 10: 2, 18: 2, 19: 4, 31: 4, 32: 4, 33: 4,
                 36: 4, 37: 8, 64: 8, 72: 8}[H]


def test_k3_rows_and_lanes_match_the_kernel_source():
    """``align_cuda.K3_ROWS`` and ``k3_lanes`` are the kernel's own: the
    rows a lane (``constexpr int K``) and the lane count ``launch_g``
    picks for each H, both read from ``csrc/align_packed.cu``, so the
    model and the edge checks probe the boundaries the kernel has."""
    import os
    import re

    src = os.path.join(os.path.dirname(align_cuda.__file__), os.pardir,
                       "csrc", "align_packed.cu")
    with open(src) as fh:
        text = fh.read()
    assert int(re.search(r"constexpr int K = (\d+);", text).group(1)) \
        == align_cuda.K3_ROWS
    body = text[text.index("cudaError_t launch_g("):]
    body = body[:body.index("\n}\n")]
    picks = [(int(m or 1), int(g)) for m, g in re.findall(
        r"if \(H <= (?:(\d+) \* )?K\) return launch<HAS_NM, TIE, (\d+)>",
        body)]
    last = int(re.search(r"\n  return launch<HAS_NM, TIE, (\d+)>",
                         body).group(1))
    assert [g for _m, g in picks] == [1, 2, 4] and last == 8
    for H in range(1, 73):
        want = next((g for m, g in picks if H <= m * align_cuda.K3_ROWS),
                    last)
        assert align_cuda.k3_lanes(H) == want, H

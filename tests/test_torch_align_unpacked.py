"""K4's lane-group schedule (``csrc/align_unpacked.cu``), modelled in
numpy, against the port's plain ``align_batch`` and the JAX package's
``align_batch(tie_flag=True)``, exactly, on all 9 fields.

The model mirrors the kernel step by step: ``k4_pick(H, table)`` lanes a
read and rows a lane, lane ``j`` on column ``s - j`` at step ``s``, only lane
0 reading the bases (a byte a column from the ``[B, L]`` rows), the
column's byte tables and ``prmt`` in the table variant or compares and
selects in the compare variant, padding rows unmasked, and after each
step exactly the values the kernel hands from lane to lane (the kernel
always computes the flags).  It runs at every (G, K) the kernel
instantiates, in both variants, on adversarial ASCII batches: ties, N in
the reads and the adapter, lowercase and U, adapters of 7 or more
distinct bytes, and the legacy stale-matrix bases of
``ops/clipper.legacy_effective_query``.

Results are integers: every comparison is exact (tolerance 0).
"""

import os
import re

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.kernels import align as ref_align
from fastx_toolkit_tpu_torch.kernels import align_unpacked_cuda as k4
from fastx_toolkit_tpu_torch.kernels.align import align_batch
from fastx_toolkit_tpu_torch.ops.clipper import legacy_effective_query
from test_torch_align_wide import (
    _FLAG,
    _G1,
    _GAP,
    _NEG,
    _NEG_BEST,
    _RISKY,
    _TS,
    FIELDS,
    _border,
    _i32,
    _nm,
    _prmt,
    _reads,
)

_N = ord("N")
_PAD_ROW, _PAD_DELTA = 256, 0x80808080
_M32 = 0xFFFFFFFF
SMALL_RNA = b"TGGAATTCTCGGGTGCCAAGG"
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


def _emulate_k4(bases, lengths, adapter, table):
    """``csrc/align_unpacked.cu``'s lane-group kernel step by step in
    numpy, in its table (``table=True``) or compare variant; arrays are
    ``[lane, read]``.  The loop runs to the batch's longest read (the
    kernel stops at its warp's; the extra steps find every lane idle).
    Returns the kernel's 9 output fields."""
    H = len(adapter)
    G, K = k4.k4_pick(H, table)
    B, L = bases.shape
    bases = bases.astype(np.int64)
    lane = np.arange(G)[:, None]
    y0 = lane * K
    ln = np.clip(lengths, 0, L)[None, :]
    ys = y0 + np.arange(K)[None, :]                                   # [G, K]
    real = ys < H
    if table:
        alpha, cls_of = k4.adapter_table(adapter)
        r = np.array(list(cls_of) + [7] * (G * K - H))[ys]
        sel = np.where(real, r | (r + 8) << 4 | (r + 8) << 8 | (r + 8) << 12,
                       0x7777)
        alpha = list(alpha) + [256] * (k4.K4_ALPHA - len(alpha))
    else:
        tb = np.array(list(adapter) + [_PAD_ROW] * (G * K - H))[ys]
    sc = np.repeat(_border(ys)[:, :, None], B, 2)         # pseudo column -1
    w1 = np.repeat(np.where(real, (ys + 1) << _TS, 0)[:, :, None], B, 2)
    w2 = np.zeros((G, K, B), np.int64)
    zero = np.zeros((G, B), np.int64)
    in_sc, in_w1, in_w2 = zero.copy(), zero.copy(), zero.copy()
    pv_sc = np.repeat(_border(y0 - 1), B, 1)
    pv_w1 = np.repeat(np.where(y0 <= H, y0 << _TS, 0), B, 1)
    pv_w2 = zero.copy()
    in_cmax, in_cw1, in_cw2, in_pk = (zero.copy() for _ in range(4))
    best = np.full(B, _NEG_BEST, np.int64)
    bw1, bw2, bx, by = (np.zeros(B, np.int64) for _ in range(4))
    bfl = np.zeros(B, bool)
    for s in range(int(ln.max(initial=0)) + G - 1):
        x = s - lane
        act = (x >= 0) & (x < ln)                                     # [G, B]
        # lane 0 reads column s of its read; the lanes below take the byte
        # (and its class) from the word handed down
        q0 = np.where(s < ln[0], bases[:, min(s, max(L - 1, 0))], 0)
        q = (in_pk >> 24) & 255
        q[0] = q0
        if table:
            c0 = np.where(q0 == _N, 6, 7)
            for c in range(k4.K4_ALPHA):
                c0 = np.where(q0 == alpha[c], c, c0)
            cls = (in_pk >> 17) & 7
            cls[0] = c0
            qn = cls == 6
        else:
            cls = zero
            qn = q == _N
        pv_sc[0], pv_w1[0], pv_w2[0] = 0, 0, s  # lane 0: the row-0 border
        in_sc[0], in_w1[0], in_w2[0] = 0, 0, s
        cmax, cw1, cw2 = in_cmax.copy(), in_cw1.copy(), in_cw2.copy()
        cby, ccnt = in_pk & 255, (in_pk >> 8) & 255
        cany = ((in_pk >> 16) & 1) == 1
        if table:
            hl = 8 * (cls & 3)
            lo, hi = cls < 4, (cls & 6) == 4
            d_lo = np.where(qn, 0x01010101,
                            0xF6F6F6F6 ^ np.where(lo, 0xFC << hl, 0))
            d_hi = np.where(qn, 0x80000101,
                            0x8001F6F6 ^ np.where(hi, 0xFC << hl, 0))
            s_lo = np.where(qn, 0x10101010,
                            0x08080808 ^ np.where(lo, 0x08 << hl, 0))
            s_hi = np.where(qn, 0x00101010,
                            0x00100808 ^ np.where(hi, 0x08 << hl, 0))
        else:
            eqd, eqs = np.where(qn, 0, 10), np.where(qn, 16, 0)
            dq, sq = np.where(qn, 1, -10), np.where(qn, 16, 8)
        up_sc, up_w1, up_w2 = pv_sc, pv_w1, pv_w2
        run_sc, run_w1, run_w2 = in_sc, in_w1, in_w2
        xr = x + 3 - y0
        for i in range(K):
            if table:
                delta = _i32(_prmt(d_lo, d_hi, sel[:, i:i + 1]))
                inc = 1 << _prmt(s_lo, s_hi, sel[:, i:i + 1])
            else:
                t = tb[:, i:i + 1]
                eq, tn = t == q, t == _N
                delta = np.where(t == _PAD_ROW, _i32(_PAD_DELTA),
                                 np.where(eq, eqd, np.where(tn, 1, dq)))
                inc = 1 << np.where(eq, eqs, np.where(tn, 16, sq))
            p_sc, p_w1, p_w2 = sc[:, i].copy(), w1[:, i].copy(), w2[:, i].copy()
            ul_sc, ul_w1, ul_w2 = up_sc + delta, (up_w1 + inc) & _M32, up_w2
            assert ul_sc.min() >= -(1 << 31)  # int32 never wraps
            left_sc = np.where(xr < i, _NEG, p_sc + _GAP)
            left_w1, left_w2 = p_w1, (p_w2 + _G1) & _M32
            lw = left_sc > ul_sc
            e_sc = np.where(lw, left_sc, ul_sc)
            e_ul = ~lw
            e_w1 = np.where(lw, left_w1, ul_w1)
            e_w2 = np.where(lw, left_w2, ul_w2)
            t1 = (left_sc == ul_sc) & ((ul_w1 | left_w1) & _RISKY != 0)
            e_w1 = np.where(t1, e_w1 | _FLAG, e_w1)
            chain_sc = run_sc + _GAP
            ywins = (e_sc > chain_sc) | ((e_sc == chain_sc) & e_ul)
            c_sc = np.where(ywins, e_sc, chain_sc)
            c_w1 = np.where(ywins, e_w1, run_w1)
            c_w2 = np.where(ywins, e_w2, (run_w2 + _G1) & _M32)
            ctie = (e_sc == chain_sc) & ((run_w1 | e_w1) & _RISKY != 0)
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
        mrisky = (np.bitwise_or.reduce(np.where(hits, w1, 0), axis=1)
                  & _RISKY) != 0
        gt = act & ((lane == 0) | (m > cmax))
        same = act & ~gt & (m == cmax)
        cmax = np.where(gt, m, cmax)
        cby = np.where(gt, y0 + mby, cby)
        cw1 = np.where(gt, m1, cw1)
        cw2 = np.where(gt, m2, cw2)
        ccnt = np.where(gt, mcnt, np.where(same, ccnt + mcnt, ccnt))
        cany = np.where(gt, mrisky, cany | (same & mrisky))
        assert cby.max() < 128 and ccnt.max() <= 128  # the word's fields
        pv_sc = np.where(act, in_sc, pv_sc)
        pv_w1 = np.where(act, in_w1, pv_w1)
        pv_w2 = np.where(act, in_w2, pv_w2)
        # the last lane folds the column max into the read's best
        a, m, c1 = act[-1], cmax[-1], cw1[-1]
        improve = a & (m > best)
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
        pk = (cby | (ccnt << 8) | (cany.astype(np.int64) << 16)
              | (cls << 17 if table else 0) | (q << 24))
        down = np.r_[0, np.arange(G - 1)]
        in_sc, in_w1, in_w2 = sc[down, K - 1], w1[down, K - 1], w2[down, K - 1]
        in_cmax, in_cw1, in_cw2, in_pk = (v[down] for v in (cmax, cw1, cw2, pk))
    return {"matches": bw1 & 0xFF, "mismatches": (bw1 >> 8) & 0xFF,
            "gaps": bw2 >> 16, "neutral": (bw1 >> 16) & 0xFF,
            "query_start": bw2 & 0xFFFF, "query_end": bx,
            "target_start": (bw1 >> _TS) & 0x7F, "target_end": by,
            "tie_fragile": bfl}


def _case_adapter(rng, H, table):
    """An adapter of ``H`` bytes: for the table variant over ACGT (at
    most 6 distinct non-N bytes, with lowercase at H >= 20), for the
    compare variant over 12 letters (7 or more distinct from H = 8);
    N bases in both where H >= 3."""
    if table:
        src = (SMALL_RNA + TRUSEQ) * 4
        ad = bytearray(src[:H])
        if H >= 20:
            ad[5], ad[11] = ord("g"), ord("a")
    else:
        ad = bytearray(b"tggaattcUcgggtgccaagg"[i % 21] for i in range(H))
        ad[:min(H, 8)] = b"ACGTucaU"[:min(H, 8)]
    if H >= 3:
        for j in rng.integers(0, H, 2):
            ad[j] = _N
    return bytes(ad)


# every (G, K) the kernel picks, at each end of its H range, in both
# variants (the compare variant also at H = 2, which the table variant
# would take in the kernel: the model forces it)
_CASES = [(H, True) for H in (1, 17, 18, 21, 22, 33, 34, 35, 72, 73, 99,
                              127)] + \
         [(H, False) for H in (2, 8, 9, 16, 17, 32, 33, 64, 65, 127)]


@pytest.mark.parametrize("H,table", _CASES)
def test_k4_schedule_model_matches_reference(H, table):
    """The numpy model of K4's wavefront equals the port's plain
    ``align_batch`` and the JAX package's ``align_batch(tie_flag=True)``
    field by field on adversarial reads (lengths of 0, 1, below the lane
    count and exactly L among them) and on the same reads' legacy
    stale-matrix bases."""
    rng = np.random.default_rng(8000 + 2 * H + table)
    B, L = 64, 80
    G, _K = k4.k4_pick(H, table)
    adapter = _case_adapter(rng, H, table)
    assert (k4.adapter_table(adapter) is not None) == table or H < 9
    alpha = b"ACGTNacgtnUu" if not table or H >= 20 else b"ACGTN"
    bases, lengths = _reads(rng, B, L, adapter,
                            alpha=np.frombuffer(alpha, np.uint8))
    lengths[:5] = [0, 1, max(0, G - 1), L, L]
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    # the same reads' legacy stale-matrix bases (running-max widths) as a
    # second half, padded to L (columns past a read's length never reach
    # its result)
    eff, widths, _carry = legacy_effective_query(bases, lengths)
    eff = np.pad(eff, ((0, 0), (0, L - eff.shape[1])))
    bs = np.concatenate([bases, eff])
    ls = np.concatenate([lengths, widths.astype(np.int32)])
    ref = ref_align.align_batch(bs, ls, adapter, tie_flag=True)
    port = align_batch(torch.from_numpy(bs), torch.from_numpy(ls), adapter,
                       tie_flag=True)
    got = _emulate_k4(bs, ls, adapter, table)
    for k in FIELDS:
        want = np.asarray(ref[k])
        np.testing.assert_array_equal(got[k], want, err_msg=k)
        np.testing.assert_array_equal(port[k].numpy(), want, err_msg=k)
    assert np.asarray(ref["tie_fragile"]).any() or H < 3


def test_k4_picks_and_gate_match_the_kernel_source():
    """``K4_TABLE_PICKS``, ``K4_COMPARE_PICKS``, ``K4_HMAX`` and
    ``K4_ALPHA`` are the kernel's own (``TABLE_PICKS``, ``COMPARE_PICKS``,
    ``HMAX`` and ``NALPHA`` in ``csrc/align_unpacked.cu``), and the kernel
    dispatches on them in order, so the model and the edge checks probe
    the (G, K) the kernel has."""
    src = os.path.join(os.path.dirname(k4.__file__), os.pardir, "csrc",
                       "align_unpacked.cu")
    with open(src) as fh:
        text = fh.read()
    for name, want, table in (("TABLE_PICKS", k4.K4_TABLE_PICKS, True),
                              ("COMPARE_PICKS", k4.K4_COMPARE_PICKS, False)):
        body = re.search(r"constexpr Pick %s\[NPICKS\] = \{(.*?)\};" % name,
                         text, re.S).group(1)
        picks = tuple(tuple(int(v) for v in m) for m in re.findall(
            r"\{(\d+), (\d+), (\d+)\}", body))
        assert picks == want, name
        rows = [r for r, _g, _k in picks]
        assert rows == sorted(rows) and rows[-1] >= k4.K4_HMAX
        for _r, g, k in picks:
            assert 32 % g == 0 and g * k <= 128
        for H in range(1, k4.K4_HMAX + 1):
            g, k = k4.k4_pick(H, table)
            assert g * k >= H and (g, k) == next(
                (pg, pk) for r, pg, pk in picks if H <= r)
    assert int(re.search(r"constexpr int NPICKS = (\d+);", text).group(1)) \
        == len(k4.K4_TABLE_PICKS) == len(k4.K4_COMPARE_PICKS)
    assert int(re.search(r"constexpr int HMAX = (\d+);", text).group(1)) \
        == k4.K4_HMAX
    assert int(re.search(r"constexpr int NALPHA = (\d+);", text).group(1)) \
        == k4.K4_ALPHA
    assert "return table ? TABLE_PICKS[p] : COMPARE_PICKS[p];" in text
    assert "if (a.H > pick(TABLE, P).rows) return launch_pick<TABLE, P + 1>" \
        in text
    assert "launch<TABLE, pick(TABLE, P).g, pick(TABLE, P).k>(a)" in text
    # the paths' adapters: H = 17 and H = 21 on one lane a read
    assert k4.k4_pick(17) == (1, 17) and k4.k4_pick(21) == (1, 21)


def test_k4_gate_and_adapter_table():
    assert k4.lanes_ok(50, 21) and k4.lanes_ok(300, 99)
    assert k4.lanes_ok(100, 127) and not k4.lanes_ok(100, 128)
    assert not k4.lanes_ok(32700, 40) and not k4.lanes_ok(100, 0)
    assert k4.adapter_table(SMALL_RNA) == (b"TGAC", bytes(
        b"TGAC".index(c) for c in SMALL_RNA))
    assert k4.adapter_table(b"NNAN") == (b"A", bytes([6, 6, 0, 6]))
    assert k4.adapter_table(b"ACGTacN") == (b"ACGTac",
                                            bytes([0, 1, 2, 3, 4, 5, 6]))
    assert k4.adapter_table(b"ACGTacg") is None      # 7 distinct bytes
    assert k4.adapter_table(b"tggaattcUcgggtgccaagg") is not None
    assert k4.adapter_table(b"tggaattcUcgggtgccaaggACGT") is None


def test_k4_beyond_the_gate_on_cpu_matches_reference():
    """An adapter of 130 bytes (beyond the lane-group gate, the serial
    route on a card) takes the plain version on CPU tensors and equals
    the reference."""
    adapter = (SMALL_RNA * 7)[:130]
    rng = np.random.default_rng(130)
    bases, lengths = _reads(rng, 16, 160, adapter,
                            alpha=np.frombuffer(b"ACGTN", np.uint8))
    assert not k4.lanes_ok(160, len(adapter))
    ref = ref_align.align_batch(bases, lengths, adapter, tie_flag=True)
    got = k4.align_batch_unpacked(torch.from_numpy(bases),
                                  torch.from_numpy(lengths), adapter,
                                  tie_flag=True)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)

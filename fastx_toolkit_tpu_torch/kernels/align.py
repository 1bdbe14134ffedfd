"""Half-local adapter alignment, batched, in plain torch.

Counterpart of ``fastx_toolkit_tpu/kernels/align.py::align_batch``: the
exact x10-integer DP (match +10, mismatch -10, gap -50, neutral +1,
N/N 0) that carries each cell's path statistics forward instead of
tracing back, with the ``tie_fragile`` flag.  See the reference's
docstring for the derivation; this module keeps its semantics bit for
bit:

* candidate priority UL > UP > LEFT (UL wins UL/LEFT ties, the row-0
  border-up candidate beats LEFT ties and loses UL ties, and a later cell
  wins an up-chain score tie only if its own winner was the UL move);
* the LEFT ban ``y > 3 and y - 3 > x`` and the target border
  ``0 if y <= 3 else GAP * (y - 3)``;
* the global best is the first (x, then y) strict maximum over
  ``x < lengths``, starting from -10,000,000;
* the fragility rules t1 (UL/LEFT tie), t2 (row-0 border tie), the
  up-chain tie, t4 (tie with the running best) and t5 (tie between rows
  at the column max).

This is the plain version the CUDA kernel K1 (``align_cuda.py``) is held
against.  State is laid out ``[H, B]``; the in-column up-chain is an
inclusive Hillis-Steele scan over the adapter rows with the reference's
combine, which is associative, so any scan order gives the same result
as the sequential chain the CUDA kernel runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GAP = -50
MATCH = 10
MISMATCH = -10
NEUTRAL = 1
_N = ord("N")

NEG = -1000000
NEG_BEST = -10000000
_SCAN_IDENTITY = -(1 << 30)

FIELDS = ("matches", "mismatches", "gaps", "neutral",
          "query_start", "query_end", "target_start", "target_end")


def _comb(a, b, tie_flag: bool):
    """Up-chain combine; ``b`` is the later block.  Tuple slots: adjusted
    score, winner-was-UL, matches, mismatches, gaps-y, neutral, qs, ts,
    fragile.  ``b`` wins a score tie only if its winner was the UL move; a
    tie with a neutral or an inherited flag on either side is fragile."""
    ywins = (b[0] > a[0]) | ((b[0] == a[0]) & b[1])
    out = tuple(torch.where(ywins, yb, ya) for ya, yb in zip(a, b))
    if tie_flag:
        tie = (b[0] == a[0]) & (((a[5] + b[5]) > 0) | a[8] | b[8])
        out = out[:8] + (out[8] | tie,)
    return out


def _shift_down(a, sh: int, fill):
    top = torch.full((sh,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([top, a[:-sh]], dim=0)


def _scan_up_chain(state, tie_flag: bool):
    """Inclusive scan over rows (dim 0) with :func:`_comb`."""
    H = state[0].shape[0]
    fills = (_SCAN_IDENTITY, False, 0, 0, 0, 0, 0, 0, False)
    sh = 1
    while sh < H:
        shifted = tuple(_shift_down(s, sh, f) for s, f in zip(state, fills))
        state = _comb(shifted, state, tie_flag)
        sh *= 2
    return state


def align_batch(bases: torch.Tensor, lengths: torch.Tensor, adapter: bytes,
                tie_flag: bool = False):
    """Align every read of ``bases`` (uint8 ``[B, L]``, any bytes beyond
    ``lengths``) against ``adapter``.  Returns a dict of int32 ``[B]``
    tensors (:data:`FIELDS`), plus ``tie_fragile`` bool ``[B]`` when
    ``tie_flag`` is set.  Runs on whatever device ``bases`` lies on."""
    dev = bases.device
    B, L = bases.shape
    H = len(adapter)
    i32 = torch.int32
    lengths = lengths.to(device=dev, dtype=i32)
    ys = torch.arange(H, dtype=i32, device=dev)[:, None]            # [H, 1]
    target_border = torch.where(ys <= 3, torch.zeros_like(ys), GAP * (ys - 3))
    tc = torch.tensor(list(adapter), dtype=i32, device=dev)[:, None]
    t_is_n = tc == _N
    row0 = ys == 0
    gap_y = GAP * ys
    ysb = ys.expand(H, B)
    zhb = torch.zeros((H, B), dtype=i32, device=dev)
    basesT = bases.to(i32).T.contiguous()                             # [L, B]

    psc = pm = pmm = pg = pnm = pqs = pts = zhb
    pfl = torch.zeros((H, B), dtype=torch.bool, device=dev)
    zb = torch.zeros(B, dtype=i32, device=dev)
    best = torch.full((B,), NEG_BEST, dtype=i32, device=dev)
    bm = bmm = bg = bnm = bqs = bts = bx = by = zb
    bfl = torch.zeros(B, dtype=torch.bool, device=dev)

    for x in range(L):
        qc = basesT[x][None, :]                                       # [1, B]
        q_is_n = qc == _N
        one_n = q_is_n | t_is_n
        eq = qc == tc
        delta = torch.where(
            q_is_n & t_is_n, 0,
            torch.where(one_n, NEUTRAL, torch.where(eq, MATCH, MISMATCH)),
        ).to(i32)
        inc_m = (~one_n & eq).to(i32)
        inc_mm = (~one_n & ~eq).to(i32)
        inc_nm = one_n.to(i32)
        first_col = x == 0

        # --- upper-left candidate: source row y-1 of the previous column
        #     (the target border for the first column, 0 at row 0) ---
        src = target_border.expand(H, B) if first_col else psc
        ul_sc = _shift_down(src, 1, 0) + delta
        fresh = row0 | first_col            # the path starts at this cell
        if first_col:
            ul_m, ul_mm, ul_nm = inc_m.expand(H, B), inc_mm.expand(H, B), \
                inc_nm.expand(H, B)
            ul_g = zhb
            ul_qs = torch.full((H, B), x, dtype=i32, device=dev)
            ul_ts = ysb
            ul_fl = torch.zeros((H, B), dtype=torch.bool, device=dev)
        else:
            ul_m = torch.where(row0, 0, _shift_down(pm, 1, 0)) + inc_m
            ul_mm = torch.where(row0, 0, _shift_down(pmm, 1, 0)) + inc_mm
            ul_nm = torch.where(row0, 0, _shift_down(pnm, 1, 0)) + inc_nm
            ul_g = torch.where(row0, 0, _shift_down(pg, 1, 0))
            ul_qs = torch.where(row0, x, _shift_down(pqs, 1, 0))
            ul_ts = torch.where(row0, ysb, _shift_down(pts, 1, 0))
            ul_fl = ~fresh & _shift_down(pfl, 1, False)

        # --- left candidate (banned off-diagonal) ---
        ban = (ys > 3) & ((ys - 3) > x)
        left_src = target_border if first_col else psc
        left_sc = torch.where(ban, NEG, left_src + GAP).to(i32).expand(H, B)
        if first_col:
            left_g = torch.ones((H, B), dtype=i32, device=dev)
            left_m = left_mm = left_nm = zhb
            left_qs = torch.full((H, B), x, dtype=i32, device=dev)
            left_ts = ysb
            left_fl = torch.zeros((H, B), dtype=torch.bool, device=dev)
        else:
            left_g = pg + 1
            left_m, left_mm, left_nm = pm, pmm, pnm
            left_qs, left_ts, left_fl = pqs, pts, pfl

        # --- UL vs LEFT (UL wins ties) ---
        lw = left_sc > ul_sc
        e_sc = torch.where(lw, left_sc, ul_sc)
        e_ul = ~lw
        e_m = torch.where(lw, left_m, ul_m)
        e_mm = torch.where(lw, left_mm, ul_mm)
        e_g = torch.where(lw, left_g, ul_g)
        e_nm = torch.where(lw, left_nm, ul_nm)
        e_qs = torch.where(lw, left_qs, ul_qs)
        e_ts = torch.where(lw, left_ts, ul_ts)
        if tie_flag:
            t1 = (left_sc == ul_sc) & (((ul_nm + left_nm) > 0) | ul_fl | left_fl)
            e_fl = torch.where(lw, left_fl, ul_fl) | t1
        else:
            e_fl = torch.zeros((H, B), dtype=torch.bool, device=dev)

        # --- row-0 border-up candidate (priority UP) ---
        up0_better = row0 & ((GAP > e_sc) | ((e_sc == GAP) & ~e_ul))
        e_sc = torch.where(up0_better, GAP, e_sc)
        e_ul = torch.where(up0_better, False, e_ul)
        e_m = torch.where(up0_better, 0, e_m)
        e_mm = torch.where(up0_better, 0, e_mm)
        e_g = torch.where(up0_better, 1, e_g)
        e_nm = torch.where(up0_better, 0, e_nm)
        e_qs = torch.where(up0_better, x, e_qs)
        e_ts = torch.where(up0_better, 0, e_ts)
        if tie_flag:
            t2 = row0 & (e_sc == GAP) & ((e_nm > 0) | e_fl)
            e_fl = torch.where(up0_better, False, e_fl) | t2

        # --- up-chain: cur[y] = best of e[k] + GAP*(y-k), k <= y ---
        c_adj, _, c_m, c_mm, c_gadj, c_nm, c_qs, c_ts, c_fl = _scan_up_chain(
            (e_sc - gap_y, e_ul, e_m, e_mm, e_g - ys, e_nm, e_qs, e_ts, e_fl),
            tie_flag)
        cur = c_adj + gap_y
        c_g = c_gadj + ys

        # --- global best: first (x, then y), strict > ---
        col_best = cur.max(dim=0).values
        ymask = cur == col_best[None, :]
        col_by = ymask.to(torch.uint8).argmax(dim=0).to(i32)

        def pick(a):
            return a.gather(0, col_by.long()[None, :])[0]

        improve = (x < lengths) & (col_best > best)
        if tie_flag:
            cfl_sel = pick(c_fl)
            t5 = (ymask.sum(dim=0) > 1) & (
                ((ymask & (c_nm > 0)).any(dim=0)) | (ymask & c_fl).any(dim=0))
            t4 = (x < lengths) & (col_best == best) & (
                ((pick(c_nm) + bnm) > 0) | cfl_sel | bfl)
            bfl = torch.where(improve, cfl_sel | t5, bfl) | t4
        best = torch.where(improve, col_best, best)
        bm = torch.where(improve, pick(c_m), bm)
        bmm = torch.where(improve, pick(c_mm), bmm)
        bg = torch.where(improve, pick(c_g), bg)
        bnm = torch.where(improve, pick(c_nm), bnm)
        bqs = torch.where(improve, pick(c_qs), bqs)
        bts = torch.where(improve, pick(c_ts), bts)
        bx = torch.where(improve, x, bx)
        by = torch.where(improve, col_by, by)

        psc, pm, pmm, pg, pnm, pqs, pts, pfl = (
            cur, c_m, c_mm, c_g, c_nm, c_qs, c_ts, c_fl)

    out = dict(zip(FIELDS, (bm, bmm, bg, bnm, bqs, bx, bts, by)))
    out = {k: v.to(i32) for k, v in out.items()}
    if tie_flag:
        out["tie_fragile"] = bfl
    return out


def align_batch_float32(bases, lengths, adapter: bytes):
    """float32 batch engine, bit-faithful to the C (numpy, host).

    The port's copy of ``fastx_toolkit_tpu/kernels/align.py::
    align_batch_float32``: FASTX-Toolkit's sequence_alignment.cpp float
    arithmetic exactly, per-cell score = float32 candidate max in the C's
    priority order (UL checked first, then UP, then LEFT), with the same
    accumulation order as the sequential fill, so its results match the
    reference binary bit for bit, including the N-read ties the
    exact-decimal engines resolve deterministically.  Vectorized over the
    batch: the (x, y) cell loops are Python, every op is a [B]-vector —
    meant for the small tie_fragile subset of a batch, not whole lanes.
    The host tie fix (``engine/hostfix.py``) takes it when the native
    codec (``native.clip_float``) is unavailable.

    Path statistics are carried forward per cell exactly like
    align_batch (the forward decisions ARE the traceback: the C's
    traceback walks the origin matrix recorded during the fill)."""
    bases = np.asarray(bases, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    B, L = bases.shape
    t = np.frombuffer(adapter, np.uint8)
    H = len(adapter)
    gap = np.float32(-5.0)
    ys = np.arange(H)
    tb = np.where(ys <= 3, np.float32(0),
                  (gap * (ys - 3).astype(np.float32)).astype(np.float32))
    tb = tb.astype(np.float32)
    t_is_n = t == _N

    # previous-column state
    psc = np.zeros((H, B), np.float32)
    pstat = np.zeros((6, H, B), np.int32)  # m, mm, g, nm, qs, ts
    best = np.full(B, np.float32(-1000000), np.float32)
    bstat = np.zeros((7, B), np.int32)  # m, mm, g, nm, qs, ts + bx
    b_y = np.zeros(B, np.int32)

    NEGBAN = np.float32(-100000)
    for x in range(L):
        qc = bases[:, x]
        q_is_n = qc == _N
        cur = np.empty((H, B), np.float32)
        cstat = np.empty((6, H, B), np.int32)
        up_sc = np.full(B, np.float32(0.0), np.float32)  # query border
        for y in range(H):
            if t_is_n[y]:
                delta = np.where(q_is_n, np.float32(0.0), np.float32(0.1))
            else:
                delta = np.where(
                    q_is_n, np.float32(0.1),
                    np.where(qc == t[y], np.float32(1.0), np.float32(-1.0)),
                ).astype(np.float32)
            # candidate scores, exactly the C's operand order
            if x == 0:
                ul_src = tb[y - 1] if y > 0 else np.float32(0.0)
                ul = np.float32(ul_src) + delta
                left = np.float32(tb[y] + gap)
                left = np.full(B, left, np.float32)
            else:
                ul_src = psc[y - 1] if y > 0 else np.float32(0.0)
                ul = (ul_src + delta).astype(np.float32)
                left = (psc[y] + gap).astype(np.float32)
            up = (up_sc + gap).astype(np.float32)
            banned = y > 3 and y - 3 > x
            if banned:
                left = np.full(B, NEGBAN, np.float32)
            # priority max: UL, then UP, then LEFT (strict >)
            s = np.maximum(ul, np.float32(-100000000))
            o = np.zeros(B, np.int8)  # 0=UL
            m_up = up > s
            s = np.where(m_up, up, s).astype(np.float32)
            o = np.where(m_up, 1, o)
            m_left = left > s
            s = np.where(m_left, left, s).astype(np.float32)
            o = np.where(m_left, 2, o)
            cur[y] = s
            # forward stats per origin
            is_match = (~q_is_n) & ~t_is_n[y] & (qc == t[y])
            is_mm = (~q_is_n) & ~t_is_n[y] & (qc != t[y])
            is_nm = q_is_n | t_is_n[y]
            if x == 0 or y == 0:  # UL source is a border: fresh path
                ul_m = is_match.astype(np.int32)
                ul_mm = is_mm.astype(np.int32)
                ul_g = np.zeros(B, np.int32)
                ul_nm = is_nm.astype(np.int32)
                ul_qs = np.full(B, x, np.int32)
                ul_ts = np.full(B, y, np.int32)
            else:
                ul_m = pstat[0, y - 1] + is_match
                ul_mm = pstat[1, y - 1] + is_mm
                ul_g = pstat[2, y - 1]
                ul_nm = pstat[3, y - 1] + is_nm
                ul_qs = pstat[4, y - 1]
                ul_ts = pstat[5, y - 1]
            if y == 0:  # UP source is the query border: fresh
                up_m = np.zeros(B, np.int32)
                up_mm = np.zeros(B, np.int32)
                up_g = np.ones(B, np.int32)
                up_nm = np.zeros(B, np.int32)
                up_qs = np.full(B, x, np.int32)
                up_ts = np.zeros(B, np.int32)
            else:
                up_m = cstat[0, y - 1]
                up_mm = cstat[1, y - 1]
                up_g = cstat[2, y - 1] + 1
                up_nm = cstat[3, y - 1]
                up_qs = cstat[4, y - 1]
                up_ts = cstat[5, y - 1]
            if x == 0:  # LEFT source is the target border: fresh
                lf_m = np.zeros(B, np.int32)
                lf_mm = np.zeros(B, np.int32)
                lf_g = np.ones(B, np.int32)
                lf_nm = np.zeros(B, np.int32)
                lf_qs = np.full(B, x, np.int32)
                lf_ts = np.full(B, y, np.int32)
            else:
                lf_m = pstat[0, y]
                lf_mm = pstat[1, y]
                lf_g = pstat[2, y] + 1
                lf_nm = pstat[3, y]
                lf_qs = pstat[4, y]
                lf_ts = pstat[5, y]
            for k, (a, b, c) in enumerate((
                (ul_m, up_m, lf_m), (ul_mm, up_mm, lf_mm),
                (ul_g, up_g, lf_g), (ul_nm, up_nm, lf_nm),
                (ul_qs, up_qs, lf_qs), (ul_ts, up_ts, lf_ts),
            )):
                cstat[k, y] = np.where(o == 0, a, np.where(o == 1, b, c))
            # global best: strict >, (x, y) fill order, x < read length
            improve = (s > best) & (x < lengths)
            best = np.where(improve, s, best).astype(np.float32)
            for k in range(6):
                bstat[k] = np.where(improve, cstat[k, y], bstat[k])
            bstat[6] = np.where(improve, x, bstat[6])
            b_y = np.where(improve, y, b_y)
            up_sc = s
        psc = cur
        pstat = cstat
    return {
        "matches": bstat[0],
        "mismatches": bstat[1],
        "gaps": bstat[2],
        "neutral": bstat[3],
        "query_start": bstat[4],
        "query_end": bstat[6],
        "target_start": bstat[5],
        "target_end": b_y,
    }


# ---------------------------------------------------------------------------
# debug printers (fastx_clipper -D / -DD), numpy: copies of the reference's
# float32 oracle and its print_matrix / SequenceAlignmentResults::print
# ---------------------------------------------------------------------------

FROM_UPPER = 1
FROM_LEFT = 2
FROM_UPPER_LEFT = 3


@dataclasses.dataclass
class AlignResult:
    query_size: int = 0
    query_start: int = 0
    query_end: int = 0
    target_size: int = 0
    target_start: int = 0
    target_end: int = 0
    gaps: int = 0
    neutral_matches: int = 0
    matches: int = 0
    mismatches: int = 0



def align_oracle(query: bytes, target: bytes) -> AlignResult:
    """Transcription of FASTX-Toolkit's HalfLocalSequenceAlignment in
    float32, like the C (bit-faithful modulo FMA): the oracle behind the
    ``-D`` debug printers."""
    W, H = len(query), len(target)
    gap = np.float32(-5.0)
    q = np.frombuffer(query, np.uint8)
    t = np.frombuffer(target, np.uint8)

    target_border = np.where(
        np.arange(H) <= 3, np.float32(0), gap * (np.arange(H) - 3).astype(np.float32)
    ).astype(np.float32)

    score = np.zeros((W, H), np.float32)
    origin = np.zeros((W, H), np.int8)

    def delta(x, y):
        if q[x] == _N and t[y] == _N:
            return np.float32(0.0)
        if q[x] == _N or t[y] == _N:
            return np.float32(0.1)
        return np.float32(1.0) if q[x] == t[y] else np.float32(-1.0)

    best = np.float32(-1000000)
    bx = by = 0
    for x in range(W):
        for y in range(H):
            # safe_score(): query_index==-1 -> target_border[target_index],
            # target_index==-1 -> query_border[query_index]==0.  At (0,0)
            # the C reads target_border[-1], an out-of-bounds vector access
            # that in practice lands on heap metadata ~ 0 (denormal); we
            # model it as 0.
            up = (score[x, y - 1] if y > 0 else np.float32(0.0)) + gap
            left = (score[x - 1, y] if x > 0 else target_border[y]) + gap
            if x > 0 and y > 0:
                ul_src = score[x - 1, y - 1]
            elif x == 0 and y > 0:
                ul_src = target_border[y - 1]
            else:
                ul_src = np.float32(0.0)
            upleft = ul_src + delta(x, y)
            if y > 3 and y - 3 > x:
                left = np.float32(-100000)
            s = np.float32(-100000000)
            o = FROM_LEFT
            if upleft > s:
                s, o = upleft, FROM_UPPER_LEFT
            if up > s:
                s, o = up, FROM_UPPER
            if left > s:
                s, o = left, FROM_LEFT
            score[x, y] = s
            origin[x, y] = o
            if s > best:
                best, bx, by = s, x, y

    # NOTE on borders in the C: safe_score(x-1, y) with x==0 returns
    # target_border[y]; safe_score(x, y-1) with y==0 returns
    # query_border[x] == 0; safe_score(x-1, y-1) with either -1 returns the
    # corresponding border -- for x==0 that's target_border[y-1], for y==0
    # query_border[x-1] == 0, and for both it's target_border[-1]
    # (query_border? no: query_index==-1 checked first -> target_border[-1],
    # an out-of-bounds read of the vector; libstdc++ returns the element
    # before the data pointer...).  In practice target_border[-1] on x==0,
    # y==0 reads vector data minus one.  We model safe_score(-1,-1) as
    # query_border path value 0, which equals target_border[0..3]=0 region
    # anyway; divergence would need a negative index read to differ from 0.
    r = AlignResult()
    r.query_size, r.target_size = W, H
    r.query_end, r.target_end = bx, by
    x, y = bx, by
    while x >= 0 and y >= 0:
        o = origin[x, y]
        r.query_start, r.target_start = x, y
        if o == FROM_LEFT:
            r.gaps += 1
            x -= 1
        elif o == FROM_UPPER:
            r.gaps += 1
            y -= 1
        else:
            if q[x] == _N or t[y] == _N:
                r.neutral_matches += 1
            elif q[x] == t[y]:
                r.matches += 1
            else:
                r.mismatches += 1
            x -= 1
            y -= 1
    return r


def align_oracle_full(query: bytes, target: bytes):
    """Oracle + full matrices and alignment strings, for the debug
    printers (print_matrix, sequence_alignment.cpp:169-228, and
    SequenceAlignmentResults::print, :15-86)."""
    W, H = len(query), len(target)
    q = np.frombuffer(query, np.uint8)
    t = np.frombuffer(target, np.uint8)
    r = align_oracle(query, target)
    # rebuild matrices (float path)
    gap = np.float32(-5.0)
    tb = np.where(np.arange(H) <= 3, np.float32(0),
                  gap * (np.arange(H) - 3).astype(np.float32)).astype(np.float32)
    score = np.zeros((W, H), np.float32)
    origin = np.zeros((W, H), np.int8)
    match = np.zeros((W, H), np.uint8)

    def delta(x, y):
        if q[x] == _N and t[y] == _N:
            return np.float32(0.0)
        if q[x] == _N or t[y] == _N:
            return np.float32(0.1)
        return np.float32(1.0) if q[x] == t[y] else np.float32(-1.0)

    for x in range(W):
        for y in range(H):
            match[x, y] = (
                ord("N") if (q[x] == _N or t[y] == _N)
                else (ord("M") if q[x] == t[y] else ord("x"))
            )
            up = (score[x, y - 1] if y > 0 else np.float32(0.0)) + gap
            left = (score[x - 1, y] if x > 0 else tb[y]) + gap
            if x > 0 and y > 0:
                ul = score[x - 1, y - 1]
            elif x == 0 and y > 0:
                ul = tb[y - 1]
            else:
                ul = np.float32(0.0)
            ul = ul + delta(x, y)
            if y > 3 and y - 3 > x:
                left = np.float32(-100000)
            s, o = np.float32(-100000000), FROM_LEFT
            if ul > s:
                s, o = ul, FROM_UPPER_LEFT
            if up > s:
                s, o = up, FROM_UPPER
            if left > s:
                s, o = left, FROM_LEFT
            score[x, y], origin[x, y] = s, o

    # alignment strings via traceback
    qa, ta = [], []
    x, y = r.query_end, r.target_end
    acc = 0.0
    while x >= 0 and y >= 0:
        o = origin[x, y]
        if o == FROM_LEFT:
            ta.append("-")
            qa.append(chr(q[x]))
            acc += -5.0
            x -= 1
        elif o == FROM_UPPER:
            ta.append(chr(t[y]))
            qa.append("-")
            acc += -5.0
            y -= 1
        else:
            ta.append(chr(t[y]))
            qa.append(chr(q[x]))
            mv = chr(match[x, y])
            acc += {"N": 0.1, "M": 1.0, "x": -1.0}[mv]
            x -= 1
            y -= 1
    return r, score, origin, match, tb, "".join(reversed(qa)), "".join(reversed(ta)), acc


def format_matrix(query: bytes, target: bytes) -> str:
    """print_matrix (sequence_alignment.cpp:192-228)."""
    _, score, origin, match, tb, _, _, _ = align_oracle_full(query, target)
    W, H = len(query), len(target)
    out = ["Score-Matrix:\n"]
    line = "%-2s%-7s" % ("-", "-")
    for x in range(W):
        line += "%-9c" % chr(query[x])
    out.append(line + "\n")
    line = "%-2s%-7s" % ("-", "-")
    for x in range(W):
        line += "%-9s" % "0"  # query_border is all zeros
    out.append(line + "\n")
    ochar = {FROM_UPPER: "|", FROM_LEFT: "-", FROM_UPPER_LEFT: "\\", 4: "="}
    for y in range(H):
        line = "%-2c%6s " % (chr(target[y]), ("%g" % tb[y]))
        for x in range(W):
            line += "%c%c%-7.1f" % (
                chr(match[x, y]), ochar.get(int(origin[x, y]), "*"), score[x, y]
            )
        out.append(line.rstrip() + "\n")
    return "".join(out)


def format_results(query: bytes, target: bytes) -> str:
    """SequenceAlignmentResults::print (sequence_alignment.cpp:15-86)."""
    r, _, _, _, _, qa, ta, acc = align_oracle_full(query, target)
    out = []
    out.append("Query-Alingment = %s\n" % qa)
    out.append("target-Alingment= %s\n" % ta)
    out.append("Alignment NOT found\n")  # alignment_found is never set
    out.append(
        "Score = %g (%d matches, %d neutral-matches, %d mismatches, %d gaps) \n"
        % (acc, r.matches, r.neutral_matches, r.mismatches, r.gaps)
    )
    out.append(
        "Query = %s(qsize %d qstart %d qend %d\n"
        % (query.decode(), r.query_size, r.query_start, r.query_end)
    )
    out.append(
        "Target= %s(tsize %d tstart %d tend %d\n"
        % (target.decode(), r.target_size, r.target_start, r.target_end)
    )
    out.append("\n")
    delta = max(r.target_start, r.query_start)
    line = ""
    if delta - r.query_start > 0:
        line += " " * (delta - r.query_start - 1)
    if r.query_start > 0:
        line += query.decode()[: r.query_start - 1]
    line += "(%s)" % qa
    if r.query_end < len(query):
        line += query.decode()[r.query_end + 1 :]
    out.append(line + "\n")
    line = " " * (delta - 1) if delta > 0 else ""
    line += "(" + "".join(
        "*" if a == b else "|" for a, b in zip(qa, ta)
    ) + ")"
    out.append(line + "\n")
    line = ""
    if delta - r.target_start > 0:
        line += " " * (delta - r.target_start)
    if r.target_start > 0:
        line += target.decode()[: r.target_start - 1]
    line += "(%s)" % ta
    if r.target_end < len(target):
        line += target.decode()[r.target_end + 1 :]
    out.append(line + "\n")
    return "".join(out)

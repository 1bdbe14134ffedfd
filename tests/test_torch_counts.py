"""The port's packed counts (K2's CPU path) against the JAX package's
``packed_counts_pallas(interpret=True)``, exactly, with and without the N
plane, at odd lengths around the 8-, 16- and 32-column boundaries of the
packed words."""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, _words_T, pack_batch2
from fastx_toolkit_tpu.kernels.counts_pallas import packed_counts_pallas
from fastx_toolkit_tpu_torch.kernels.counts_cuda import packed_counts

BOUNDARY_LENGTHS = [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 70]


@pytest.mark.parametrize("with_nm", [False, True])
@pytest.mark.parametrize("L", [24, 70])
def test_packed_counts_matches_reference(with_nm, L):
    rng = np.random.default_rng(L * 2 + with_nm)
    B = 128
    alpha = np.frombuffer(b"ACGTN" if with_nm else b"ACGT", np.uint8)
    bases = rng.choice(alpha, size=(B, L))
    # homopolymer-rich rows so the max letter count varies
    bases[::5, : L // 2] = ord("A")
    bases[1::7, L // 3:] = ord("T")
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lens = [x for x in BOUNDARY_LENGTHS if x <= L]
    lengths = np.resize(np.asarray(lens, np.int32), B)
    lengths[len(lens):] = rng.integers(0, L + 1, B - len(lens))

    cfg = PipelineConfig(with_filter=False, with_qtrim=False)  # mask q20
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=True)
    # effective-N plane: input N OR masked position
    nmb = planes[:, 0] | planes[:, 1]
    L32 = -(-L // 32) * 32
    b2w = np.asarray(_words_T(b2, L32 // 4))
    nmw = np.asarray(_words_T(nmb, L32 // 8)) if with_nm else None

    rw, rn = packed_counts_pallas(b2w, nmw, lengths, tile_b=B,
                                  interpret=True)
    gw, gn = packed_counts(
        torch.tensor(b2w.view(np.int32)),
        None if nmw is None else torch.tensor(nmw.view(np.int32)),
        torch.from_numpy(lengths))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw), err_msg="worst")
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn), err_msg="ncnt")
    if with_nm:
        assert np.asarray(rn).any()


# K2's word-at-a-time count (csrc/packed_counts.cu), modelled in numpy
_REV = np.array([int("{:08b}".format(i)[::-1], 2) for i in range(256)],
                np.uint8)
_EVEN = np.uint32(0x55555555)
_U = 8  # code words a thread loads before counting


def _rev_bytes_bits(x):
    """The bits of each byte of uint32 ``x`` reversed (BREV, then PRMT)."""
    return _REV[np.ascontiguousarray(x, np.uint32).view(np.uint8)].view(
        np.uint32).reshape(np.shape(x))


def _spread16(x):
    """Bits 0..15 to the even bits 0..30."""
    x = x.astype(np.uint32) & np.uint32(0xFFFF)
    for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                        (1, 0x55555555)):
        x = (x | (x << np.uint32(shift))) & np.uint32(mask)
    return x


def _popc(x):
    return np.bitwise_count(x.astype(np.uint32)).astype(np.int64)


def k2_word_model(b2w, nmw, lengths):
    """The kernel's schedule: per read, U code words and U/2 N words loaded
    a round, each 16-base word's codes and N bits aligned on the even bits,
    the tail masked by the length, five popcounts."""
    b2w = np.asarray(b2w).view(np.uint32)
    nmw = None if nmw is None else np.asarray(nmw).view(np.uint32)
    W16, B = b2w.shape
    lens = np.minimum(np.asarray(lengths, np.int64), W16 * 16)
    nw = np.where(lens > 0, (lens + 15) >> 4, 0)
    c1, c2, c3, cl, cn = (np.zeros(B, np.int64) for _ in range(5))
    for w0 in range(0, W16, _U):
        live0 = w0 < nw
        wb = [np.where(live0 & (w0 + k < nw), b2w[w0 + k], 0).astype(np.uint32)
              if w0 + k < W16 else np.zeros(B, np.uint32) for k in range(_U)]
        wn = [np.where(live0 & (w0 + 2 * k < nw), nmw[w0 // 2 + k], 0)
              .astype(np.uint32) if nmw is not None and w0 // 2 + k < W16 // 2
              else np.zeros(B, np.uint32) for k in range(_U // 2)]
        for k in range(_U):
            n = lens - 16 * (w0 + k)
            live = live0 & (n > 0)
            tail = ((np.uint32(1) << (2 * np.clip(n, 0, 15)).astype(np.uint32))
                    - np.uint32(1)) & _EVEN
            v = np.where(live, np.where(n >= 16, _EVEN, tail), 0).astype(
                np.uint32)
            r = _rev_bytes_bits(wb[k])
            hi = r & _EVEN
            lo = (r >> np.uint32(1)) & _EVEN
            if nmw is not None:
                nb = _spread16(_rev_bytes_bits(wn[k >> 1])
                               >> np.uint32(16 * (k & 1)))
                cn += _popc(v & nb)
                v &= ~nb
            cl += _popc(v)
            c1 += _popc(v & ~hi & lo)
            c2 += _popc(v & hi & ~lo)
            c3 += _popc(v & hi & lo)
    worst = np.maximum(np.maximum(cl - c1 - c2 - c3, c1), np.maximum(c2, c3))
    return worst.astype(np.int32), cn.astype(np.int32)


def test_bit_layouts_after_byte_reversal():
    """Reversing each byte's bits puts position y's code at bits 2y (high)
    and 2y + 1 (low), and an N word's position x at bit x."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (64, 16))
    word = np.zeros(64, np.uint32)
    for x in range(16):
        shift = 8 * ((x >> 2) & 3) + 6 - 2 * (x & 3)
        word |= (codes[:, x].astype(np.uint32) << np.uint32(shift))
    r = _rev_bytes_bits(word)
    for y in range(16):
        hi = (r >> np.uint32(2 * y)) & np.uint32(1)
        lo = (r >> np.uint32(2 * y + 1)) & np.uint32(1)
        np.testing.assert_array_equal(hi * 2 + lo, codes[:, y])
    bits = rng.integers(0, 2, (64, 32))
    nword = np.zeros(64, np.uint32)
    for x in range(32):
        nword |= bits[:, x].astype(np.uint32) << np.uint32(
            8 * ((x >> 3) & 3) + 7 - (x & 7))
    nr = _rev_bytes_bits(nword)
    for x in range(32):
        np.testing.assert_array_equal((nr >> np.uint32(x)) & np.uint32(1),
                                      bits[:, x])
    np.testing.assert_array_equal(
        _spread16(np.uint32(0xFFFF) * np.ones(1, np.uint32)), [0x55555555])


def _edge_operands(W16, with_nm, seed):
    """Random words, N bits set on word edges (positions 0, 15, 16, 31 of
    each 32), and lengths 0, 1, 15, 16, 17, 31, 32, 33, W16 * 16 and past
    it, then random."""
    rng = np.random.default_rng(seed)
    B = 300
    b2w = rng.integers(0, 1 << 32, (W16, B), dtype=np.uint64).astype(np.uint32)
    b2w[:, ::9] = 0            # all A
    b2w[:, 1::9] = 0xFFFFFFFF  # all T
    nmw = None
    if with_nm:
        nmw = (rng.random((W16 // 2, B)) < 0.3) * rng.integers(
            0, 1 << 32, (W16 // 2, B), dtype=np.uint64)
        nmw = nmw.astype(np.uint32)
        for x in (0, 15, 16, 31):   # N bits on word edges
            nmw[:, 2::5] |= np.uint32(1 << (8 * ((x >> 3) & 3) + 7 - (x & 7)))
    lens = [0, 1, 15, 16, 17, 31, 32, 33, W16 * 16, W16 * 16 + 5, -3]
    lengths = rng.integers(0, W16 * 16 + 1, B).astype(np.int32)
    lengths[:len(lens)] = lens
    lengths[len(lens):2 * len(lens)] = lens
    return b2w, nmw, lengths


@pytest.mark.parametrize("with_nm", [False, True])
@pytest.mark.parametrize("W16", [2, 4, 8, 10, 20])
def test_k2_word_schedule_matches_reference_and_plain(W16, with_nm):
    """The numpy model of the kernel's word-at-a-time count against the
    Pallas kernel in interpret mode and the plain version, exactly."""
    b2w, nmw, lengths = _edge_operands(W16, with_nm, W16 * 2 + with_nm)
    got = k2_word_model(b2w, nmw, lengths)
    pw, pn = packed_counts(
        torch.from_numpy(b2w.view(np.int32)),
        None if nmw is None else torch.from_numpy(nmw.view(np.int32)),
        torch.from_numpy(lengths))
    np.testing.assert_array_equal(got[0], pw.numpy(), err_msg="worst, plain")
    np.testing.assert_array_equal(got[1], pn.numpy(), err_msg="ncnt, plain")
    B = len(lengths)
    Bp = -(-B // 128) * 128
    pad = ((0, 0), (0, Bp - B))
    rw, rn = packed_counts_pallas(
        np.pad(b2w, pad), None if nmw is None else np.pad(nmw, pad),
        np.pad(lengths, (0, Bp - B)), tile_b=128,
        interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(rw)[:B], err_msg="worst")
    np.testing.assert_array_equal(got[1], np.asarray(rn)[:B], err_msg="ncnt")
    if with_nm:
        assert got[1].any()

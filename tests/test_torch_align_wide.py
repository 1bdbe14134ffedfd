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
  ACGTN, lowercase and U bytes, and at H=99 vs ``align_batch``.

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

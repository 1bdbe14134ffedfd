"""The port's adapter DP against the JAX package's, exactly.

* ``kernels/align.py::align_batch`` (plain torch) vs the reference
  ``align_batch(tie_flag=True)`` on all 9 fields, over the cases of
  tests/test_align.py and tests/test_tie_parity.py;
* ``kernels/align_cuda.py::align_batch_packed`` on CPU tensors (its plain
  path) vs the reference ``align_batch_pallas_packed(interpret=True)`` on
  the five parametrisations of tests/test_align.py's P12 test.

Results are integers: every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.kernels import align as ref_align
from fastx_toolkit_tpu_torch.kernels import align as port_align
from fastx_toolkit_tpu_torch.kernels.align_cuda import align_batch_packed

FIELDS = (
    "matches", "mismatches", "gaps", "neutral", "query_start", "query_end",
    "target_start", "target_end", "tie_fragile",
)
ADAPTER = b"CTGTAGGCACCATCAAT"
ALPHA = np.frombuffer(b"ACGTN", np.uint8)


def _batchify(reads):
    L = max(len(r) for r in reads)
    bases = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return bases, lengths


def _random_uniform(rng):
    reads = [bytes(rng.choice(ALPHA, size=36)) for _ in range(200)]
    return _batchify(reads), b"CAATTGGTTAATCCCCCTATATA"


def _adapter_embedded(rng):
    alpha = ALPHA[:4]
    reads = []
    for _ in range(100):
        pos = int(rng.integers(0, 30))
        ad = bytearray(ADAPTER)
        for _ in range(int(rng.integers(0, 3))):
            ad[int(rng.integers(0, len(ad)))] = int(rng.choice(alpha))
        read = (bytes(rng.choice(alpha, size=pos)) + bytes(ad)
                + bytes(rng.choice(alpha, size=10)))[:36]
        reads.append(read.ljust(36, b"A"))
    return _batchify(reads), ADAPTER


def _mixed_lengths(rng):
    reads = [bytes(rng.choice(ALPHA, size=int(rng.integers(5, 64))))
             for _ in range(100)]
    return _batchify(reads), b"CCTTAAGG"


def _short_reads(rng):
    return _batchify([b"A", b"AC", b"CCTT", b"ACGTACGT", b"N", b""]), \
        b"CCTTAAGG"


def _border_gaps_and_ban(rng):
    """Adapter prefixes at the read starts and ends: the target border,
    the row-0 border gap and the LEFT ban (y > 3 and y - 3 > x) decide
    these alignments."""
    reads = [ADAPTER[k:] + b"ACGT" for k in range(0, 12)]
    reads += [b"GATTACA" + ADAPTER[:k] for k in range(1, 17)]
    reads += [ADAPTER[:8] + b"T" + ADAPTER[8:], ADAPTER[:5] + ADAPTER[7:]]
    return _batchify(reads), ADAPTER


def _nlane(rng, n_rate):
    """tests/test_tie_parity.py::_nlane: N-heavy, adapter-spiked reads —
    the lanes with real decimal ties."""
    B, L = 96, 60
    p = [(1 - n_rate) / 4] * 4 + [n_rate]
    bases = rng.choice(ALPHA, size=(B, L), p=p)
    pos = rng.integers(0, max(1, L - 5), B)
    for j, ch in enumerate(ADAPTER):
        m = (rng.random(B) < 0.5) & (pos + j < L)
        bases[m, (pos + j)[m]] = ch
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    return (bases, lengths), ADAPTER


def _ties_heavy(rng):
    return _nlane(rng, 0.15)


def _ties_light(rng):
    return _nlane(rng, 0.04)


def _n_adapter(rng):
    (bases, lengths), _ = _nlane(rng, 0.1)
    return (bases, lengths), b"CTGNAGGCANCATCAAT"


CASES = {f.__name__.lstrip("_"): f for f in (
    _random_uniform, _adapter_embedded, _mixed_lengths, _short_reads,
    _border_gaps_and_ban, _ties_heavy, _ties_light, _n_adapter)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_batch_matches_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case) + 100)
    (bases, lengths), adapter = CASES[case](rng)
    ref = {k: np.asarray(v) for k, v in ref_align.align_batch(
        bases, lengths, adapter, tie_flag=True).items()}
    got = port_align.align_batch(torch.from_numpy(bases),
                                 torch.from_numpy(lengths), adapter,
                                 tie_flag=True)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    if case.startswith("ties"):
        assert ref["tie_fragile"].any()  # the case really has fragile ties


def _packed_operands(bases, quals, adapter):
    """The reference's packed word layout (pack_batch2 + _words_T), as in
    tests/test_align.py."""
    from fastx_toolkit_tpu.engine.pipeline import (
        PipelineConfig,
        _words_T,
        pack_batch2,
    )

    B, L = bases.shape
    cfg = PipelineConfig(adapter=adapter)
    b_for_pack = np.where(bases == 0, ord("A"), bases).astype(np.uint8)
    b2, planes = pack_batch2(b_for_pack, quals, cfg, n_plane=True)
    L32 = -(-L // 32) * 32
    b2w = np.asarray(_words_T(b2, L32 // 4))
    nmw = np.asarray(_words_T(planes[:, 0], L32 // 8))
    return b2w, nmw


@pytest.mark.parametrize("adapter,L,n_frac,B", [  # noqa: E741
    (b"CTGTAGGCACCATCAAT", 100, 0.05, 64),          # headline shape
    (b"CCTTAAGGCCTTAAGGCCTTAAGGCCTTAAG", 100, 0.05, 64),  # H=31 bound
    (b"CTGTAGGCACCATCAAT", 511, 0.03, 16),          # L=511 bound
    (b"CCTTAAGG", 8, 0.2, 64),                      # tiny reads
    (b"CTGTAGGCACCATCAAT", 100, 0.0, 64),           # nmw=None shortcut
])
def test_align_batch_packed_matches_reference_p12(adapter, L, n_frac, B,
                                                  monkeypatch):
    from fastx_toolkit_tpu.kernels.align_pallas import (
        align_batch_pallas_packed,
    )

    monkeypatch.delenv("FASTX_TPU_NO_P12", raising=False)
    rng = np.random.default_rng(L + len(adapter))
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    bases = rng.choice(ALPHA, size=(B, L), p=p)
    for i in range(0, B, 3):  # spike noisy adapters for realistic hits
        pos = int(rng.integers(0, max(1, L - len(adapter))))
        ad = bytearray(adapter)
        for _ in range(int(rng.integers(0, 3))):
            ad[int(rng.integers(0, len(ad)))] = int(rng.choice(ALPHA[:4]))
        bases[i, pos:pos + len(ad)] = np.frombuffer(bytes(ad), np.uint8)[:L - pos]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    quals = np.full((B, L), 30, np.int8)
    b2w, nmw = _packed_operands(bases, quals, adapter)
    if n_frac == 0.0:
        nmw = None  # N-free: no plane shipped, flags provably zero
    ref = {k: np.asarray(v) for k, v in align_batch_pallas_packed(
        b2w, nmw, lengths, adapter, L=L, tile_b=B, interpret=True,
        tie_flag=True).items()}
    got = align_batch_packed(
        torch.tensor(b2w.view(np.int32)),
        None if nmw is None else torch.tensor(nmw.view(np.int32)),
        torch.from_numpy(lengths), adapter, L=L, tie_flag=True)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_align_batch_packed_rejects_what_k1_cannot_take():
    """What neither packed kernel (K1, K3) takes raises: an adapter
    outside ACGTN, one over K3's 72 bases, words that do not cover L,
    lengths of the wrong type."""
    b2w = torch.zeros((8, 4), dtype=torch.int32)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside ACGTN"):
        align_batch_packed(b2w, None, lengths, b"ACGU", L=100)
    with pytest.raises(ValueError, match="bounds"):
        align_batch_packed(b2w, None, lengths, b"A" * 73, L=100)
    with pytest.raises(ValueError, match="cover"):
        align_batch_packed(b2w, None, lengths, b"ACGT", L=200)
    with pytest.raises(ValueError, match="lengths"):
        align_batch_packed(b2w, None, lengths.long(), b"ACGT", L=100)

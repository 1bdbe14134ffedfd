"""The port's per-read transforms (``ops/transforms.py``) against the JAX
package's, exactly, on seeded padded batches (PAD beyond each read's
length), every trimmer mode, and DNA/RNA nucleotide changes."""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.ops import transforms as ref
from fastx_toolkit_tpu_torch.ops import transforms as port


def _batch(seed, B=48, L=40, alphabet=b"ACGTNU"):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
    quals = rng.integers(-5, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:4] = [0, 1, L - 1, L]
    pad = np.arange(L)[None, :] >= lengths[:, None]
    bases[pad] = 0
    quals[pad] = 0
    return bases, quals, lengths


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _eq(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g.astype(w.dtype), w)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(last=25),
    dict(first=5),
    dict(first=3, last=30),
    dict(first=41),
    dict(trim_end=4),
    dict(trim_end=4, min_len=20),
    dict(trim_end=40),
])
def test_trimmer(kw):
    b, q, l = _batch(1)  # noqa: E741
    _eq(port.trimmer(*_t(b, q, l), **kw), ref.trimmer(b, q, l, **kw))


@pytest.mark.parametrize("q,p", [(20, 50), (30, 90), (2, 100), (41, 1)])
def test_quality_filter_keep(q, p):
    b, qs, l = _batch(2)  # noqa: E741
    _eq(port.quality_filter_keep(*_t(qs, l), min_quality=q, min_percent=p),
        ref.quality_filter_keep(qs, l, min_quality=q, min_percent=p))


@pytest.mark.parametrize("t,m", [(20, 0), (30, 15), (50, 0)])
def test_quality_trimmer(t, m):
    b, q, l = _batch(3)  # noqa: E741
    _eq(port.quality_trimmer(*_t(b, q, l), threshold=t, min_len=m),
        ref.quality_trimmer(b, q, l, threshold=t, min_len=m))


@pytest.mark.parametrize("mask", [ord("N"), ord("X")])
def test_masker(mask):
    b, q, l = _batch(4)  # noqa: E741
    _eq(port.masker(*_t(b, q, l), threshold=20, mask_char=mask),
        ref.masker(b, q, l, threshold=20, mask_char=mask))


def test_contains_n_artifacts_and_to_fasta():
    b, q, l = _batch(5, alphabet=b"AAAAACGTN")  # noqa: E741
    bt, lt = _t(b, l)
    _eq(port.contains_n(bt, lt), ref.contains_n(b, l))
    _eq(port.artifacts_keep(bt, lt), ref.artifacts_keep(b, l))
    for discard_n in (False, True):
        _eq(port.fastq_to_fasta_keep(bt, lt, discard_n=discard_n),
            ref.fastq_to_fasta_keep(b, l, discard_n=discard_n))
    assert not port.artifacts_keep(bt, lt).all()


@pytest.mark.parametrize("is_fastq", [True, False])
def test_reverse_complement(is_fastq):
    b, q, l = _batch(6, alphabet=b"ACGTNUacgtnu")  # noqa: E741
    _eq(port.reverse_complement(*_t(b, q, l), is_fastq=is_fastq),
        ref.reverse_complement(b, q, l, is_fastq=is_fastq))


@pytest.mark.parametrize("rna_mode,alphabet", [
    (True, b"ACGT"), (True, b"ACGTU"), (False, b"ACGU"), (False, b"ACGTU"),
])
def test_nucleotide_changer(rna_mode, alphabet):
    b, q, l = _batch(7, alphabet=alphabet)  # noqa: E741
    _eq(port.nucleotide_changer(*_t(b, l), rna_mode=rna_mode),
        ref.nucleotide_changer(b, l, rna_mode=rna_mode))


def test_zero_pad():
    b, q, l = _batch(8)  # noqa: E741
    short = np.maximum(l - 5, 0).astype(np.int32)
    _eq(port._zero_pad(*_t(b, q, short)), ref._zero_pad(b, q, short))

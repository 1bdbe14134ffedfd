"""The port's quality-stats reduction against the JAX package's, on the
same seeded numpy inputs, every comparison exact: K5's plain versions
(``stats_hist_plain``, ``stats_hist_b2_plain``) against the Pallas kernel
in interpret mode, the plain scatter ``accumulate`` (FASTQ, and FASTA
with collapsed counts), ``derive_from_hist``, ``counts_only``, the
accumulator's merge when L grows, and the report renderers on
accumulators that reach the reference's out-of-bounds walk."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, pack_batch2
from fastx_toolkit_tpu.kernels.stats_pallas import (
    stats_hist_pallas,
    stats_hist_pallas_b2,
)
from fastx_toolkit_tpu.ops import stats as ref_stats
from fastx_toolkit_tpu_torch.core.records import BaseCode
from fastx_toolkit_tpu_torch.kernels import stats_cuda
from fastx_toolkit_tpu_torch.ops import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("count", "hist", "qsum", "qmin", "qmax")


def _batch(seed, B, L, alphabet=b"ACGTN", qlo=-5, qhi=41):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
    quals = rng.integers(qlo, qhi, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    return bases, quals, lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("B,L,tile_b", [(512, 24, 128), (128, 200, 64)])
def test_hist_plain_matches_pallas(B, L, tile_b):
    """(128, 200) is the reference's 128-position-block geometry; bytes
    outside ACGTN and qualities outside [-15, 93] reach slot 0 and the
    clipped edge bins."""
    bases, quals, lengths = _batch(B + L, B, L, alphabet=b"ACGTNacgtnX.")
    quals[::7, ::3] = np.int8(-40)
    quals[::5, ::4] = np.int8(120)
    want = np.asarray(stats_hist_pallas(bases, quals, lengths, tile_b=tile_b,
                                        interpret=True))
    got = stats_cuda.stats_hist(*_t(bases, quals, lengths))
    assert got.dtype == torch.int32 and tuple(got.shape) == (L, 6, 109)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        stats_cuda.stats_hist_plain(*_t(bases, quals, lengths)).numpy(), want)


def test_hist_b2_plain_matches_pallas():
    bases, quals, lengths = _batch(13, 256, 21, alphabet=b"ACGT")
    cfg0 = PipelineConfig(with_filter=False, with_qtrim=False, with_mask=False)
    b2, _ = pack_batch2(bases, quals, cfg0, n_plane=False)
    want = np.asarray(stats_hist_pallas_b2(b2, quals, lengths, tile_b=128,
                                           interpret=True))
    got = stats_cuda.stats_hist_b2(*_t(b2, quals, lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    ascii_ = stats_cuda.stats_hist(*_t(bases, quals, lengths))
    np.testing.assert_array_equal(got.numpy(), ascii_.numpy())


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    before = (stats_cuda.launches, stats_cuda.b2_launches)
    bases, quals, lengths = _batch(3, 40, 33)
    stats_cuda.stats_hist(*_t(bases, quals, lengths))
    b2 = np.zeros((40, 9), np.uint8)
    stats_cuda.stats_hist_b2(*_t(b2, quals, lengths))
    assert (stats_cuda.launches, stats_cuda.b2_launches) == before
    with pytest.raises(ValueError):
        stats_cuda.stats_hist(*_t(bases, quals.astype(np.int16), lengths))
    with pytest.raises(ValueError):
        stats_cuda.stats_hist_b2(*_t(b2[:, :8], quals, lengths))


def test_kernel_slot_table_is_stats_index():
    """The __constant__ table in csrc/stats_hist.cu is BaseCode.STATS_INDEX."""
    with open(os.path.join(ROOT, "fastx_toolkit_tpu_torch", "csrc",
                           "stats_hist.cu")) as fh:
        src = fh.read()
    body = re.search(r"c_stats_index\[256\] = \{(.*?)\};", src, re.S).group(1)
    table = [int(v) for v in re.findall(r"\d+", body)]
    assert table == BaseCode.STATS_INDEX.tolist()


@pytest.mark.parametrize("is_fastq", [True, False])
def test_accumulate_matches_reference(is_fastq):
    bases, quals, lengths = _batch(9 + is_fastq, 300, 40,
                                   alphabet=b"ACGTNacgX", qlo=-15, qhi=94)
    rng = np.random.default_rng(4)
    counts = (np.ones(300, np.int32) if is_fastq
              else rng.integers(1, 8, 300).astype(np.int32))
    want = ref_stats.accumulate(bases, quals, lengths, counts,
                                is_fastq=is_fastq)
    got = stats.accumulate(*_t(bases, quals, lengths, counts),
                           is_fastq=is_fastq)
    _equal(got, want)
    disp = stats.accumulate_dispatch(*_t(bases, quals, lengths, counts),
                                     is_fastq=is_fastq)
    _equal(disp, want)


def test_derive_from_hist_matches_reference():
    bases, quals, lengths = _batch(21, 200, 30, alphabet=b"ACGTNx")
    pernuc = np.asarray(stats_hist_pallas(bases, quals, lengths, tile_b=200,
                                          interpret=True))
    want = ref_stats.derive_from_hist(pernuc)
    _equal(stats.derive_from_hist(pernuc), want)
    _equal(stats.derive_from_hist(torch.from_numpy(pernuc.copy())), want)


def test_counts_only_matches_reference():
    bases, quals, lengths = _batch(10, 64, 40, alphabet=b"ACGTNz")
    counts = np.random.default_rng(10).integers(1, 7, 64).astype(np.int32)
    want = ref_stats.counts_only(jnp.asarray(bases), jnp.asarray(lengths),
                                 jnp.asarray(counts))
    got = stats.counts_only(*_t(bases, lengths, counts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _accumulators(parts_list):
    """The same partials merged into both packages' accumulators."""
    ref = ref_stats.StatsAccumulator.empty(0)
    got = stats.StatsAccumulator.empty(0)
    for parts in parts_list:
        ref.merge_partial(*[np.asarray(p) for p in parts])
        got.merge_partial(*parts)
    return ref, got


def test_merge_partial_grows_with_l():
    parts = []
    for seed, L in ((1, 12), (2, 30), (3, 20)):
        bases, quals, lengths = _batch(seed, 50, L)
        parts.append(stats.accumulate(*_t(bases, quals, lengths,
                                          np.ones(50, np.int32)),
                                      is_fastq=True))
    ref, got = _accumulators(parts)
    assert got.count.shape == (30, 6)
    _equal([getattr(got, n) for n in NAMES], [getattr(ref, n) for n in NAMES])
    assert got.num_cycles() == ref.num_cycles()


@pytest.mark.parametrize("is_fastq,qlo,qhi", [
    (False, 0, 41),    # FASTA: empty histograms, the out-of-bounds walk
    (True, -15, -5),   # negative sums: the unsigned mean
    (True, -15, 94),   # the whole quality range
])
def test_renderers_match_reference(is_fastq, qlo, qhi):
    bases, quals, lengths = _batch(31, 40, 25, alphabet=b"ACGTNq",
                                   qlo=qlo, qhi=qhi)
    lengths[:3] = 25
    counts = np.random.default_rng(5).integers(1, 8, 40).astype(np.int32)
    if is_fastq:
        counts[:] = 1
    parts = stats.accumulate(*_t(bases, quals, lengths, counts),
                             is_fastq=is_fastq)
    ref, got = _accumulators([parts])
    if not is_fastq:
        assert got.hist.sum() == 0 and got.count.sum() > 0
    else:
        assert (got.qsum < 0).any() or qhi > 0
    assert stats.render_old_format(got) == ref_stats.render_old_format(ref)
    assert stats.render_new_format(got) == ref_stats.render_new_format(ref)

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


# K5's schedule (csrc/stats_hist.cu), modelled in numpy
H100_OPTIN = 232448  # opt-in shared memory a block on an H100
CU = os.path.join(ROOT, "fastx_toolkit_tpu_torch", "csrc", "stats_hist.cu")


def _flat_bytes(a):
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def _staged(flat, lo, hi, base=0):
    """A stage's copy of bytes [lo, hi) of ``flat`` (an array at address
    ``base``): the 16-byte chunks that hold the span, and the offset of
    byte ``lo`` in them."""
    a0 = (base + lo) & ~15
    end = -(-(base + hi) // 16) * 16
    buf = np.zeros(end - a0, np.uint8)
    src_lo = max(a0 - base, 0)
    src_hi = min(end - base, len(flat))
    buf[src_lo + base - a0:src_hi + base - a0] = flat[src_lo:src_hi]
    return buf, base + lo - a0


def k5_tile_model(codes, quals, lengths, b2, active, base=(0, 0, 0)):
    """The one-tile kernel: the plan's read ranges, each block's stages
    copied from aligned chunks (arrays at addresses ``base``), its tile of
    16-bit bin pairs [327][P], and each cluster's sums over its blocks'
    tiles, a slice of the words a block."""
    B, L = quals.shape
    W = codes.shape[1]
    blocks, per, R, P, smem = stats_cuda.k5_plan(B, L, W, active, H100_OPTIN)
    assert smem <= H100_OPTIN and per <= stats_cuda.K5_CAP
    assert blocks % stats_cuda.K5_CLUSTER == 0
    fc, fq = _flat_bytes(codes), _flat_bytes(quals)
    fl = _flat_bytes(lengths.astype(np.int32))
    lut = BaseCode.STATS_INDEX.astype(np.int64) * 109
    tiles = np.zeros((blocks, stats_cuda.FW * P), np.uint32)
    for blk in range(blocks):
        r0 = min(B, blk * per)
        r1 = min(B, r0 + per)
        for ra in range(r0, r1, R):
            rb = min(r1, ra + R)
            sc, oc = _staged(fc, ra * W, rb * W, base[0])
            sq, oq = _staged(fq, ra * L, rb * L, base[1])
            sl, ol = _staged(fl, ra * 4, rb * 4, base[2])
            n = rb - ra
            c = sc[oc:oc + n * W].reshape(n, W).astype(np.int64)
            q = sq[oq:oq + n * L].view(np.int8).reshape(n, L).astype(np.int64)
            ln = np.minimum(sl[ol:ol + 4 * n].view(np.int32), L)
            pos = np.arange(L)
            if b2:
                slot = ((c[:, pos >> 2] >> (6 - 2 * (pos & 3))) & 3) + 1
                ids = slot * 109
            else:
                ids = lut[c]
            ids = ids + np.clip(q + 15, 0, 108)
            live = pos[None, :] < ln[:, None]
            col = np.broadcast_to(pos, (n, L))[live]
            ids = ids[live]
            np.add.at(tiles[blk], (ids >> 1) * P + col,
                      (np.uint32(1) << (16 * (ids & 1)).astype(np.uint32)))
    out = np.zeros((L, 654), np.int64)
    C = stats_cuda.K5_CLUSTER
    for c0 in range(0, blocks, C):
        group = tiles[c0:c0 + C]
        for rank in range(C):
            w0, w1 = stats_cuda.FW * rank // C, stats_cuda.FW * (rank + 1) // C
            words = group[:, w0 * P:w1 * P].reshape(C, w1 - w0, P)[:, :, :L]
            lo = (words & np.uint32(0xFFFF)).astype(np.int64).sum(axis=0)
            hi = (words >> np.uint32(16)).astype(np.int64).sum(axis=0)
            out[:, 2 * w0:2 * w1:2] += lo.T
            out[:, 2 * w0 + 1:2 * w1:2] += hi.T
    return out.astype(np.int32).reshape(L, 6, 109)


def k5_tiled_model(codes, quals, lengths, b2, sms):
    """The tiled kernel: position tiles of 32 by read ranges, 32-bit
    counters, each tile's non-zero bins added to the output."""
    B, L = quals.shape
    tiles = -(-L // 32)
    ranges = min(-(-2 * sms // tiles), -(-B // 16))
    per = -(-B // ranges)
    plain = stats_cuda.stats_hist_b2_plain if b2 else stats_cuda.stats_hist_plain
    out = np.zeros((L, 6, 109), np.int32)
    for t in range(tiles):
        cols = slice(32 * t, min(L, 32 * t + 32))
        for r0 in range(0, B, per):
            rows = slice(r0, min(B, r0 + per))
            part = plain(*_t(codes[rows], quals[rows],
                               np.clip(lengths[rows], None, L)))
            out[cols] += part.numpy()[cols]
    return out


def _k5_cases():
    cases = []
    for L in (1, 31, 32, 33, 64, 65, 128, 160, 301):
        for b2 in (False, True):
            cases.append((L, b2))
    return cases


@pytest.mark.parametrize("L,b2", _k5_cases())
def test_k5_schedule_matches_reference_and_plain(L, b2):
    """The numpy model of the new kernel's schedule (the one-tile kernel up
    to L = 160, the tiled kernel beyond) against the Pallas kernel in
    interpret mode and the plain version, exactly; lengths 0, 1, L, past L
    and negative among random ones, qualities outside [-15, 93] and bytes
    outside ACGTN; arrays at unaligned addresses, and a few clusters
    resident so that blocks take several stages."""
    B = 1024
    bases, quals, lengths = _batch(L * 7 + b2, B, L,
                                   alphabet=b"ACGT" if b2 else b"ACGTNacgtnX.",
                                   qlo=-40, qhi=120)
    lengths[:5] = [0, 1, L, L + 9, -4]
    if b2:
        cfg0 = PipelineConfig(with_filter=False, with_qtrim=False,
                              with_mask=False)
        codes, _ = pack_batch2(bases, quals, cfg0, n_plane=False)
        codes = np.asarray(codes)
        want = np.asarray(stats_hist_pallas_b2(codes, quals, lengths,
                                               tile_b=128, interpret=True))
        plain = stats_cuda.stats_hist_b2_plain(*_t(codes, quals, lengths))
    else:
        codes = bases
        want = np.asarray(stats_hist_pallas(bases, quals, lengths,
                                            tile_b=128, interpret=True))
        plain = stats_cuda.stats_hist_plain(*_t(bases, quals, lengths))
    np.testing.assert_array_equal(plain.numpy(), want)
    if stats_cuda.tile_ok(L, codes.shape[1]):
        for active, base in ((1, (0, 0, 0)), (3, (5, 13, 4))):
            got = k5_tile_model(codes, quals, lengths, b2, active, base)
            np.testing.assert_array_equal(got, want, err_msg=str(active))
    else:
        assert L > stats_cuda.K5_LMAX
        np.testing.assert_array_equal(
            k5_tiled_model(codes, quals, lengths, b2, 132), want)


def test_k5_counter_cap_one_bin():
    """More reads than one cluster's blocks may tally (4 x 65,535), all in
    one bin: the plan caps a block at 65,535 reads and adds blocks, so no
    16-bit half carries."""
    B = 4 * stats_cuda.K5_CAP + 1000
    bases = np.full((B, 2), ord("A"), np.uint8)
    quals = np.full((B, 2), 37, np.int8)
    lengths = np.full(B, 2, np.int32)
    blocks, per, *_ = stats_cuda.k5_plan(B, 2, 2, 1, H100_OPTIN)
    assert per == stats_cuda.K5_CAP and blocks == 8
    got = k5_tile_model(bases, quals, lengths, False, 1)
    want = stats_cuda.stats_hist_plain(*_t(bases, quals, lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 1, 37 + 15].tolist() == [B, B]


def test_k5_plan_shapes():
    """The phase-3 shapes' plans on an H100 with 33 clusters of 4 resident:
    one block an SM, every tally warp the same reads a stage."""
    plan = stats_cuda.k5_plan(262144, 128, 128, 33, H100_OPTIN)
    assert plan[:4] == (132, 1986, 93, 128)
    plan = stats_cuda.k5_plan(262144, 160, 160, 33, H100_OPTIN)
    assert plan[:4] == (132, 1986, 31, 160)
    assert stats_cuda.k5_plan(262144, 128, 32, 33, H100_OPTIN)[2] % 31 == 0
    assert not stats_cuda.tile_ok(161, 161) and not stats_cuda.tile_ok(100, 161)


def test_k5_constants_match_the_kernel():
    """The wrapper's mirror of the one-tile kernel's constants equals the
    constexprs of csrc/stats_hist.cu."""
    with open(CU) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["LMAX"]) == stats_cuda.K5_LMAX
    assert int(consts["CAP"]) == stats_cuda.K5_CAP
    assert int(consts["WARPS"]) == stats_cuda.K5_WARPS
    assert consts["THREADS"] == "32 * (WARPS + 1)"
    assert consts["HEAD_BYTES"] == "LUT_BYTES + 16 * STAGES"
    assert int(consts["STAGES"]) == stats_cuda.K5_STAGES
    assert int(consts["RMAX"]) == stats_cuda.K5_RMAX
    assert int(consts["MIN_PER"]) == stats_cuda.K5_MIN_PER
    assert int(consts["CLUSTER"]) == stats_cuda.K5_CLUSTER
    assert consts["LUT_BYTES"] == "256 * 2" and stats_cuda.K5_LUT_BYTES == 512

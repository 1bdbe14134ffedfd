"""The port's CUDA kernels on the card against their plain PyTorch versions
on the same CUDA tensors, and the on-card engine, the collapse functions
and the CLIs against their CPU runs.

Every test is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  On a machine with a card, which has no jax,
run from the repository root:

    FASTX_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_cuda.py -q

(``FASTX_TPU_TEST_REAL=1`` keeps tests/conftest.py from importing jax.)
Results are integers and bytes: every comparison is exact (tolerance 0).
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu_torch.cli.tools._shared import BatchReader
from fastx_toolkit_tpu_torch.core import codec, native
from fastx_toolkit_tpu_torch.engine import lines
from fastx_toolkit_tpu_torch.engine.pipeline import (
    PipelineConfig,
    _thresholds,
    _words_T,
    packed_decisions_pipeline,
)
from fastx_toolkit_tpu_torch.kernels import (
    align_cuda,
    align_unpacked_cuda,
    counts_cuda,
)
from fastx_toolkit_tpu_torch.kernels.align import align_batch

pytestmark = pytest.mark.cuda

FIELDS = ("matches", "mismatches", "gaps", "neutral", "query_start",
          "query_end", "target_start", "target_end", "tie_fragile")
ADAPTER = b"CTGTAGGCACCATCAAT"
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
SMALL_RNA = b"TGGAATTCTCGGGTGCCAAGG"
ALPHA = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(seed, B, L, n_frac, adapter, device):
    """Random reads with noisy adapters spiked in, lengths 0..L, packed as
    the engine packs them: ``(b2w, nmw, lengths)`` on ``device``."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(ALPHA, size=(B, L), p=[(1 - n_frac) / 4] * 4 + [n_frac])
    pos = rng.integers(0, max(1, L - len(adapter)), B)
    ad = np.frombuffer(adapter, np.uint8)
    for j in range(len(ad)):
        m = (rng.random(B) < 0.4) & (pos + j < L)
        col = np.where(rng.random(B) < 0.9, ad[j], rng.choice(ALPHA[:4], B))
        bases[m, (pos + j)[m]] = col[m]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = ord("A")
    b2, planes = native.pack2(np.ascontiguousarray(bases),
                              np.full((B, L), 30, np.int8), (), True)
    L32 = -(-L // 32) * 32
    b2w = _words_T(torch.from_numpy(b2), L32 // 4)
    nmw = _words_T(torch.from_numpy(np.ascontiguousarray(planes[:, 0])),
                   L32 // 8)
    return b2w.to(device), nmw.to(device), torch.from_numpy(lengths).to(device)


@pytest.mark.parametrize("adapter,L,n_frac,B,with_nm,tie", [
    (ADAPTER, 100, 0.05, 4096, True, True),          # headline shape
    (ADAPTER, 100, 0.05, 1000, True, False),         # ragged B, flag-free
    (ADAPTER, 100, 0.0, 1000, False, True),          # nmw=None shortcut
    (b"CCTTAAGGCCTTAAGGCCTTAAGGCCTTAAG", 100, 0.05, 2048, True, True),  # H=31
    (b"CTGNAGGCANCATCAAT", 100, 0.1, 2048, False, True),  # N in the adapter
    (ADAPTER, 511, 0.03, 512, True, True),           # L=511
    (b"CCTTAAGG", 8, 0.2, 333, True, True),          # tiny reads
])
def test_k1_matches_plain_on_card(dev, adapter, L, n_frac, B, with_nm, tie):
    b2w, nmw, lengths = _operands(L + B, B, L, n_frac, adapter, dev)
    if not with_nm:
        nmw = None
    # K1's shapes launch the lane-group kernel of csrc/align_packed.cu,
    # counted on K1's counter
    before = (align_cuda.launches, align_cuda.wide_launches)
    got = align_cuda.align_batch_packed(b2w, nmw, lengths, adapter, L=L,
                                        tie_flag=tie)
    assert (align_cuda.launches, align_cuda.wide_launches) == \
        (before[0] + 1, before[1])
    want = align_cuda.align_batch_packed_plain(b2w, nmw, lengths, adapter,
                                               L=L, tie_flag=tie)
    for k in FIELDS[:8] + (("tie_fragile",) if tie else ()):
        assert got[k].device == dev
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype),
                                   rtol=0, atol=0, msg=k)


# K3 at the edges of its lane groups (align_cuda.K3_ROWS = 9 rows a lane):
# H = 1, k, k + 1, 2k, 2k + 1, 31-33, 4k, 4k + 1, 64, 72 on a ragged B of
# 1,001 reads (L = 600 below H = 32, where K1 takes L <= 511), the four
# (N plane, flags) variants in turn; odd H carry N adapter bases
_K3_EDGES = [
    ((b"ACGTN" + TRUSEQ * 3)[:H] if H % 2 else (TRUSEQ * 3)[:H],
     600 if H < 32 else 150, 0.05, 1001, n % 4 < 2, n % 2 == 0)
    for n, H in enumerate((1, 9, 10, 18, 19, 31, 32, 33, 36, 37, 64, 72))]


@pytest.mark.parametrize("adapter,L,n_frac,B,with_nm,tie", [
    (TRUSEQ, 150, 0.03, 4096, True, True),           # 33-base TruSeq
    (TRUSEQ, 150, 0.03, 1000, True, False),          # ragged B, flag-free
    (TRUSEQ, 150, 0.0, 1000, False, True),           # nmw=None shortcut
    (b"ACGTN" * 14 + b"AC", 600, 0.05, 512, True, True),  # H=72, L=600
    (ADAPTER, 600, 0.03, 300, True, True),           # L > 511 with H=17
    (TRUSEQ, 150, 0.05, 1, True, True),              # B=1
    *_K3_EDGES,
    (TRUSEQ, 4000, 0.03, 256, True, True),           # long reads
    (TRUSEQ, 4000, 0.03, 256, False, False),
])
def test_k3_matches_plain_on_card(dev, adapter, L, n_frac, B, with_nm, tie):
    b2w, nmw, lengths = _operands(L + B + 1, B, L, n_frac, adapter, dev)
    if not with_nm:
        nmw = None
    # lengths 0, 1, below the lane count and exactly L on rows 1-4, where
    # B has them; row 0 keeps its random length
    edge = [0, 1, max(0, align_cuda.k3_lanes(len(adapter)) - 1), L][:B - 1]
    lengths[1:1 + len(edge)] = torch.tensor(edge, dtype=torch.int32)
    before = (align_cuda.launches, align_cuda.wide_launches)
    got = align_cuda.align_batch_packed(b2w, nmw, lengths, adapter, L=L,
                                        tie_flag=tie)
    assert (align_cuda.launches, align_cuda.wide_launches) == \
        (before[0], before[1] + 1)
    want = align_cuda.align_batch_packed_plain(b2w, nmw, lengths, adapter,
                                               L=L, tie_flag=tie)
    for k in FIELDS[:8] + (("tie_fragile",) if tie else ()):
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype),
                                   rtol=0, atol=0, msg=k)


def _ascii_reads(seed, B, L, adapter, alphabet=b"ACGTN"):
    """ASCII reads over ``alphabet`` with noisy copies of ``adapter``
    spiked in and random lengths 0..L: ``(bases, lengths)`` numpy."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    bases = rng.choice(alpha, size=(B, L))
    pos = rng.integers(0, max(1, L - len(adapter)), B)
    ad = np.frombuffer(adapter, np.uint8)
    for j in range(len(ad)):
        m = (rng.random(B) < 0.4) & (pos + j < L)
        col = np.where(rng.random(B) < 0.9, ad[j], rng.choice(alpha, B))
        bases[m, (pos + j)[m]] = col[m]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    return bases, lengths


def _k4_edge_adapter(H, table):
    """An adapter of ``H`` bytes over ACGT with N bases (K4's table
    variant), or over 12 letters with 7 or more distinct non-N bytes from
    H = 8 (its compare variant)."""
    return (b"ACGTN" + SMALL_RNA * 7 if table
            else b"ACGTNacgU" + b"tggaattcUcgggtgccaagg" * 7)[:H]


# K4 at the edges of its (G, K) picks (align_unpacked_cuda.K4_TABLE_PICKS:
# 17, 21, 34, 72 and 128 rows; K4_COMPARE_PICKS: 8, 16, 32, 64 and 128),
# on a ragged B of 1,001 reads, in the table variant and, from H = 8, the
# compare variant; H = 128 is beyond the lane-group kernel's gate (the
# one-thread-per-read route)
_K4_EDGES = [
    (_k4_edge_adapter(H, table), 150, 1001,
     b"ACGTN" if table else b"ACGTNacgtnUu")
    for H in (1, 8, 9, 16, 17, 18, 21, 22, 32, 33, 34, 35, 64, 65, 72, 73, 99,
              127, 128)
    for table in ((True, False) if H >= 8 else (True,))]


@pytest.mark.parametrize("adapter,L,B,alphabet", [
    (SMALL_RNA, 50, 4096, b"ACGTN"),                 # small-RNA shape
    (b"tggaattcUcgggtgccaagg" * 4 + b"ACGNNUuuuACGTNa", 300, 512,
     b"ACGTNacgtnUu"),                               # H=99, compare variant
    (b"CCTTAAGG", 64, 300, b"ACGTNacgU"),            # B=300
    (SMALL_RNA, 50, 1, b"ACGTN"),                    # B=1
    *_K4_EDGES,
])
@pytest.mark.parametrize("tie", [True, False])
def test_k4_matches_plain_on_card(dev, adapter, L, B, alphabet, tie):
    bases, lengths = _ascii_reads(B + L, B, L, adapter, alphabet)
    # lengths 0, 1, below the lane count and exactly L on rows 1-4, where
    # B has them; row 0 keeps its random length
    lanes_ok = align_unpacked_cuda.lanes_ok(L, len(adapter))
    table = align_unpacked_cuda.adapter_table(adapter) is not None
    G = align_unpacked_cuda.k4_pick(len(adapter), table)[0] if lanes_ok else 1
    edge = [0, 1, max(0, G - 1), L][:B - 1]
    lengths[1:1 + len(edge)] = edge
    bt = torch.from_numpy(bases).to(dev)
    lt = torch.from_numpy(lengths).to(dev)
    before = (align_unpacked_cuda.launches,
              align_unpacked_cuda.serial_launches)
    got = align_unpacked_cuda.align_batch_unpacked(bt, lt, adapter,
                                                   tie_flag=tie)
    assert (align_unpacked_cuda.launches,
            align_unpacked_cuda.serial_launches) == \
        (before[0] + lanes_ok, before[1] + (not lanes_ok))
    want = align_batch(bt, lt, adapter, tie_flag=tie)
    for k in FIELDS[:8] + (("tie_fragile",) if tie else ()):
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype),
                                   rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("tie", [True, False])
def test_k4_serial_route_on_wide_reads_on_card(dev, tie):
    """Reads of width 32,750 (L + H + H_pad >= 2^15) take the
    one-thread-per-read route; their lengths stay below 1,000, so the
    plain version on the first 1,000 columns is the same function
    (columns at or past a read's length never reach its result)."""
    L, B = 32750, 64
    bases, lengths = _ascii_reads(L, B, L, SMALL_RNA)
    lengths = lengths % 1001
    lengths[1:3] = [0, 1]
    assert not align_unpacked_cuda.lanes_ok(L, len(SMALL_RNA))
    bt = torch.from_numpy(bases).to(dev)
    lt = torch.from_numpy(lengths).to(dev)
    before = (align_unpacked_cuda.launches,
              align_unpacked_cuda.serial_launches)
    got = align_unpacked_cuda.align_batch_unpacked(bt, lt, SMALL_RNA,
                                                   tie_flag=tie)
    assert (align_unpacked_cuda.launches,
            align_unpacked_cuda.serial_launches) == (before[0], before[1] + 1)
    want = align_batch(bt[:, :1000], lt, SMALL_RNA, tie_flag=tie)
    for k in FIELDS[:8] + (("tie_fragile",) if tie else ()):
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype),
                                   rtol=0, atol=0, msg=k)


def test_k4_pick_in_the_library_equals_the_wrappers(dev):
    """The library's gate and (G, K) picks (``fx_align_unpacked_pick``)
    equal the wrapper's ``lanes_ok`` and ``k4_pick``, in both variants."""
    from fastx_toolkit_tpu_torch.kernels import _build

    lib = _build.library()
    for H in range(1, 140):
        for L in (50, 32700, 32768 - H - align_cuda._h_pad(H)):
            for table in (True, False):
                got = lib.fx_align_unpacked_pick(H, L, int(table))
                want = (align_unpacked_cuda.k4_pick(H, table)
                        if align_unpacked_cuda.lanes_ok(L, H) else None)
                assert ((got >> 8, got & 255) if got else None) == want, \
                    (H, L, table)


@pytest.mark.parametrize("L,with_nm", [(24, True), (70, False), (70, True),
                                       (511, True)])
def test_k2_matches_plain_on_card(dev, L, with_nm):
    b2w, nmw, lengths = _operands(L, 1500, L, 0.1, ADAPTER, dev)
    if not with_nm:
        nmw = None
    before = counts_cuda.launches
    worst, ncnt = counts_cuda.packed_counts(b2w, nmw, lengths)
    assert counts_cuda.launches == before + 1
    w_plain, n_plain = counts_cuda.packed_counts_plain(b2w, nmw, lengths)
    torch.testing.assert_close(worst, w_plain, rtol=0, atol=0)
    torch.testing.assert_close(ncnt, n_plain, rtol=0, atol=0)


def test_cuda_operands_are_checked_not_routed_to_plain(dev):
    b2w, nmw, lengths = _operands(5, 64, 100, 0.05, ADAPTER, dev)
    before = (align_cuda.launches, counts_cuda.launches)
    with pytest.raises(ValueError, match="lengths"):
        align_cuda.align_batch_packed(b2w, nmw, lengths.long(), ADAPTER, L=100)
    with pytest.raises(ValueError, match="nmw"):
        counts_cuda.packed_counts(b2w, nmw.cpu(), lengths)
    assert (align_cuda.launches, counts_cuda.launches) == before


def _chunk_planes(seed, B, L):
    """Random FASTQ-like reads packed with the headline chain's planes
    (N plane first): ``(b2, planes, lengths)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(ALPHA, size=(B, L), p=[0.24] * 4 + [0.04])
    pos = rng.integers(0, L - 5, B)
    for j, ch in enumerate(ADAPTER):
        m = (rng.random(B) < 0.35) & (pos + j < L)
        bases[m, (pos + j)[m]] = ch
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int16)
    b2, planes = native.pack2(np.ascontiguousarray(bases), quals,
                              _thresholds(PipelineConfig()), True)
    return b2, planes, lengths


def test_decisions_on_card_match_cpu(dev):
    cfg = PipelineConfig()
    b2, planes, lengths = _chunk_planes(11, 3000, 100)
    before = (align_cuda.launches, counts_cuda.launches)
    got = packed_decisions_pipeline(cfg, b2, planes, lengths,
                                    has_n_plane=True, device=dev,
                                    tie_flag=True)
    assert (align_cuda.launches, counts_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = packed_decisions_pipeline(cfg, b2, planes, lengths,
                                     has_n_plane=True, device="cpu",
                                     tie_flag=True)
    for g, w, name in zip(got, want, ("l", "keep", "fragile")):
        assert torch.equal(g.cpu(), w), name
    assert want[2].any()


def _lane(n, seed):
    """Adapter-spiked reads of 20-100 bp; the second half carries Ns."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(20, 101))
        p = [0.23] * 4 + [0.08] if i >= n // 2 else [0.25] * 4 + [0.0]
        seq = rng.choice(ALPHA, size=ln, p=p)
        if rng.random() < 0.5:
            at = int(rng.integers(0, ln))
            ad = np.frombuffer(ADAPTER, np.uint8)[: ln - at]
            seq[at:at + len(ad)] = ad
        q = (np.clip(rng.normal(30, 8, ln), 2, 40) + 33).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    return b"".join(recs)


def _stream(data, device, chunk_rows):
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                         block_bytes=65536, stream=io.BytesIO(data))
    eng = lines.LineEngines(PipelineConfig(), device)
    out = []
    counts = lines.stream_pipeline_lines(
        reader, PipelineConfig(), out_fastq=True, q_offset=33,
        write=out.append, device=device, chunk_rows=chunk_rows, engines=eng)
    return counts, b"".join(out), eng.fragile_rows


def test_stream_on_card_matches_cpu(dev):
    data = _lane(6000, seed=12)
    before = (align_cuda.launches, counts_cuda.launches)
    got = _stream(data, dev, chunk_rows=1000)
    launched = (align_cuda.launches - before[0],
                counts_cuda.launches - before[1])
    want = _stream(data, "cpu", chunk_rows=1000)
    assert got == want
    assert want[0][0] == 6000 and want[2] > 0
    assert min(launched) >= 6  # every dispatch went through both kernels


def _cli_run(tool, argv, data, device, monkeypatch):
    from fastx_toolkit_tpu_torch.cli.common import CliContext

    monkeypatch.setenv("FASTX_TORCH_DEVICE", device)
    out, err = io.BytesIO(), io.StringIO()
    ctx = CliContext(prog="t", stdin=io.BytesIO(data), stdout=out,
                     stderr=err, stdout_text=io.StringIO())
    status = tool.tool_main(ctx, argv)
    return status, out.getvalue(), err.getvalue()


def test_clipper_cli_on_card_matches_cpu(dev, monkeypatch):
    """The standalone clipper (K4, legacy carry across small batches)."""
    from fastx_toolkit_tpu_torch.cli.tools import fastx_clipper
    from fastx_toolkit_tpu_torch.synth import synth_small_rna_lane_bytes

    monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", "65536")
    data = synth_small_rna_lane_bytes(5000, 50, seed=13)
    argv = ["-Q", "33", "-a", SMALL_RNA.decode(), "-l", "15", "-c", "-v"]
    before = align_unpacked_cuda.launches
    got = _cli_run(fastx_clipper, argv, data, "cuda", monkeypatch)
    launched = align_unpacked_cuda.launches - before
    want = _cli_run(fastx_clipper, argv, data, "cpu", monkeypatch)
    assert got == want and want[0] == 0
    assert launched >= 5  # one per batch of the 5000 reads


@pytest.mark.parametrize("argv", [
    ["-v", "-Q", "33", "fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
     "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
     "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | fastx_artifacts_filter"],
    ["-Q", "33", "fastx_reverse_complement | fastx_clipper -a "
     + SMALL_RNA.decode() + " -c -d 2 | fastq_to_fasta -r"],
])
def test_pipeline_classic_loop_on_card_matches_cpu(dev, argv, monkeypatch):
    from fastx_toolkit_tpu_torch.cli.tools import fastx_pipeline

    data = _lane(3000, seed=14)
    before = align_unpacked_cuda.launches
    got = _cli_run(fastx_pipeline, argv, data, "cuda", monkeypatch)
    launched = align_unpacked_cuda.launches - before
    want = _cli_run(fastx_pipeline, argv, data, "cpu", monkeypatch)
    assert got == want and want[0] == 0
    assert launched >= 1


def test_stream_truseq_on_card_matches_cpu(dev):
    """The line engine with the 33-base adapter: K3 and K2, never K1."""
    cfg = PipelineConfig(adapter=TRUSEQ)
    data = _lane(4000, seed=15).replace(ADAPTER, TRUSEQ[:len(ADAPTER)])
    outs = []
    for device in (dev, "cpu"):
        args = SimpleNamespace(input_filename="<test>", q_offset=33)
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             block_bytes=65536, stream=io.BytesIO(data))
        before = (align_cuda.launches, align_cuda.wide_launches)
        w = []
        counts = lines.stream_pipeline_lines(
            reader, cfg, out_fastq=True, q_offset=33, write=w.append,
            device=device, chunk_rows=1000,
            engines=lines.LineEngines(cfg, device))
        outs.append((counts, b"".join(w)))
        if device == dev:
            assert align_cuda.launches == before[0]
            assert align_cuda.wide_launches - before[1] >= 4
    assert outs[0] == outs[1]


def _stats_operands(seed, B, L, alphabet=b"ACGTN", qlo=2, qhi=41,
                    one_q=None):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
    quals = (np.full((B, L), one_q, np.int8) if one_q is not None
             else rng.integers(qlo, qhi, size=(B, L)).astype(np.int8))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:B // 2] = L
    return bases, quals, lengths


def _k5_route_counters():
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    return (stats_cuda.launches, stats_cuda.b2_launches,
            stats_cuda.tiled_launches)


@pytest.mark.parametrize("B,L,kw", [
    (262144, 128, {}),
    (262144, 160, {}),
    (50000, 128, {"one_q": 37}),
    (20000, 100, {"alphabet": b"ACGTNacgtnX.-*", "qlo": -128, "qhi": 128}),
    (1, 128, {}), (300, 128, {}), (3000, 301, {}),
])
def test_k5_matches_plain_on_card(dev, B, L, kw):
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    bases, quals, lengths = (torch.from_numpy(a).to(dev)
                             for a in _stats_operands(B + L, B, L, **kw))
    before = _k5_route_counters()
    got = stats_cuda.stats_hist(bases, quals, lengths)
    want = stats_cuda.stats_hist_plain(bases, quals, lengths)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_k5_route_counters(), before)]
    assert moved == ([1, 0, 0] if stats_cuda.tile_ok(L, L) else [0, 0, 1])
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) == int(lengths.clamp(max=L).sum())


@pytest.mark.parametrize("B,L", [(262144, 100), (300, 150), (1, 301)])
def test_k5b_matches_plain_on_card(dev, B, L):
    from fastx_toolkit_tpu_torch.engine.pipeline import pack_batch2
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    bases, quals, lengths = _stats_operands(B * 7 + L, B, L, alphabet=b"ACGT")
    b2, _ = pack_batch2(bases, quals, PipelineConfig(), n_plane=False)
    b2, quals, lengths = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (b2, quals, lengths))
    before = _k5_route_counters()
    got = stats_cuda.stats_hist_b2(b2, quals, lengths)
    want = stats_cuda.stats_hist_b2_plain(b2, quals, lengths)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_k5_route_counters(), before)]
    assert moved == ([0, 1, 0] if stats_cuda.tile_ok(L, b2.shape[1])
                     else [0, 0, 1])
    assert torch.equal(got, want)
    assert torch.equal(got, stats_cuda.stats_hist(
        torch.from_numpy(bases).to(dev), quals, lengths))


@pytest.mark.parametrize("b2", [False, True])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 64, 65, 128, 160, 301])
def test_k5_edges_on_card(dev, L, b2):
    """K5 at the edges of its routes and tiles (the one-tile kernel up to
    L = 160, the tiled kernel past it), lengths 0, 1, L, past L and
    negative among random ones, and the quals at an odd address; each call
    on its route's counter."""
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    bases, quals, lengths = _stats_operands(L * 3 + b2, 5001, L,
                                            alphabet=b"ACGT", qlo=-20,
                                            qhi=100)
    lengths[:5] = [0, 1, L, L + 9, -4]
    codes = (native.pack2(bases, quals, (), False)[0] if b2 else bases)
    codes, quals, lengths = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (codes, quals, lengths))
    odd = torch.empty(quals.numel() + 1, dtype=torch.int8,
                      device=dev)[1:].view(quals.shape)
    odd.copy_(quals)
    tiled = not stats_cuda.tile_ok(L, codes.shape[1])
    kernel = stats_cuda.stats_hist_b2 if b2 else stats_cuda.stats_hist
    plain = stats_cuda.stats_hist_b2_plain if b2 else stats_cuda.stats_hist_plain
    want = plain(codes, quals, lengths)
    for q in (quals, odd):
        before = _k5_route_counters()
        got = kernel(codes, q, lengths)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip(_k5_route_counters(), before)]
        assert moved == ([0, 0, 1] if tiled else [0, 1, 0] if b2
                         else [1, 0, 0])
        assert torch.equal(got, want)


def test_k5_counter_overflow_one_bin_on_card(dev):
    """More reads than the resident blocks may tally into 16-bit halves
    (clusters x 4 x 65,535), all on one base and one quality."""
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    plan = stats_cuda.library_plan(262144, 4, 4, False)
    B = plan["active"] * stats_cuda.K5_CLUSTER * stats_cuda.K5_CAP + 4097
    bases = torch.full((B, 4), ord("A"), dtype=torch.uint8, device=dev)
    quals = torch.full((B, 4), 37, dtype=torch.int8, device=dev)
    lengths = torch.full((B,), 4, dtype=torch.int32, device=dev)
    got = stats_cuda.stats_hist(bases, quals, lengths)
    torch.cuda.synchronize()
    assert got[:, 1, 37 + 15].tolist() == [B] * 4
    assert int(got.sum()) == 4 * B


@pytest.mark.parametrize("B,L,W,b2", [
    (262144, 128, 128, False), (262144, 160, 160, False),
    (262144, 128, 32, True), (1, 1, 1, False), (5001, 33, 9, True),
    (8192, 301, 301, False), (300, 100, 161, True), (10 ** 7, 4, 4, False)])
def test_k5_plan_in_the_library_equals_the_wrappers(dev, B, L, W, b2):
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    lp = stats_cuda.library_plan(B, L, W, b2)
    assert lp["tile"] == stats_cuda.tile_ok(L, W)
    if lp["tile"]:
        assert (lp["blocks"], lp["per"], lp["R"], lp["P"], lp["smem"]) == \
            stats_cuda.k5_plan(B, L, W, lp["active"], lp["optin"])
        assert lp["smem"] <= lp["optin"]


@pytest.mark.parametrize("with_nm", [False, True])
@pytest.mark.parametrize("L", [64, 150, 600])
def test_k2_edges_on_card(dev, L, with_nm):
    """K2 at its word edges: lengths 0, 1, 15-17, 31-33, the words' end,
    past it and negative, N bits at positions 0, 15, 16 and 31 of each 32."""
    b2w, nmw, lengths = _operands(L + 7, 3001, L, 0.05, ADAPTER, dev)
    nmw[:, 2::5] |= (1 << 7) | (1 << 8) | (1 << 23) | (1 << 24)
    W16 = b2w.shape[0]
    lengths[:11] = torch.tensor([0, 1, 15, 16, 17, 31, 32, 33, W16 * 16,
                                 W16 * 16 + 7, -3], dtype=torch.int32)
    if not with_nm:
        nmw = None
    before = counts_cuda.launches
    worst, ncnt = counts_cuda.packed_counts(b2w, nmw, lengths)
    assert counts_cuda.launches == before + 1
    w_plain, n_plain = counts_cuda.packed_counts_plain(b2w, nmw, lengths)
    torch.cuda.synchronize()
    assert torch.equal(worst, w_plain) and torch.equal(ncnt, n_plain)


@pytest.mark.parametrize("argv", [["-Q", "33"], ["-Q", "33", "-N"]])
def test_stats_cli_on_card_matches_cpu(dev, argv, monkeypatch):
    """fastx_quality_stats on the device engine (K5) over several blocks,
    equal to its CPU run and to the host engine, the default."""
    from fastx_toolkit_tpu_torch.cli.tools import fastx_quality_stats
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", "100000")
    monkeypatch.setenv("FASTX_STATS_PATH", "device")
    data = _lane(4000, seed=16)
    before = stats_cuda.launches
    got = _cli_run(fastx_quality_stats, argv, data, "cuda", monkeypatch)
    launched = stats_cuda.launches - before
    want = _cli_run(fastx_quality_stats, argv, data, "cpu", monkeypatch)
    monkeypatch.delenv("FASTX_STATS_PATH")
    before = stats_cuda.launches
    host = _cli_run(fastx_quality_stats, argv, data, "cuda", monkeypatch)
    assert got == want == host and want[0] == 0
    assert launched >= 4  # one per block
    assert stats_cuda.launches == before  # the default engine is the host


@pytest.mark.parametrize("residence", ["reg", "smem"])
@pytest.mark.parametrize("case,dpx", [
    ("dependent", False), ("dependent", True), ("independent", False),
    ("dependent_i16", False), ("dependent_i16", True),
    ("independent_i16", False)])
def test_plane_probe_matches_plain_on_card(dev, residence, case, dpx):
    """Every probe variant at every H the kernel is built for (ragged B),
    and at the TPU's shape with its K and U (the int16 chains wrap)."""
    from fastx_toolkit_tpu_torch.kernels import probe_cuda
    from fastx_toolkit_tpu_torch.kernels.probe import (
        CASES,
        TPU_B,
        TPU_K,
        TPU_U,
        plane_probe_plain,
    )

    _dep, h_tpu, dtype = CASES[case]
    before = probe_cuda.launches
    shapes = [(H, 1000, 3, 64) for H in probe_cuda.H_SET]
    shapes.append((h_tpu, TPU_B, TPU_K, TPU_U))
    for H, B, K, U in shapes:
        got = probe_cuda.plane_probe(
            case, torch.empty(B, dtype=dtype, device=dev), H=H, K=K, U=U,
            residence=residence, dpx=dpx)
        want = plane_probe_plain(case, H, B, K, U, device=dev)
        assert torch.equal(got, want), (H, B, K, U)
    assert probe_cuda.launches - before == len(shapes)


def test_plane_probe_cuda_output_is_checked_not_routed_to_plain(dev):
    from fastx_toolkit_tpu_torch.kernels import probe_cuda

    before = probe_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        probe_cuda.plane_probe("dependent",
                               torch.empty(64, dtype=torch.int16, device=dev),
                               H=24, K=1, U=16)
    with pytest.raises(ValueError, match="contiguous"):
        probe_cuda.plane_probe(
            "dependent", torch.empty(128, dtype=torch.int32, device=dev)[::2],
            H=24, K=1, U=16)
    assert probe_cuda.launches == before


def _collapse_operands(seed, B, W, pool=40):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (pool, W), dtype=np.uint64)
    words = words[rng.integers(0, pool, B)].astype(np.uint32)
    counts = rng.integers(1, 6, B).astype(np.int32)
    first_idx = rng.permutation(B).astype(np.int32)
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(counts),
            torch.from_numpy(first_idx))


@pytest.mark.parametrize("B,W", [(1, 1), (5000, 1), (5000, 2), (20000, 8)])
@pytest.mark.parametrize("form", ["exact", "hashed", "unit", "weak"])
def test_collapse_on_card_matches_cpu(dev, B, W, form):
    """ops/collapse on CUDA tensors equals its CPU run (every output; the
    weak hash forces the collision)."""
    from fastx_toolkit_tpu_torch.ops import collapse

    ops = _collapse_operands(B + W, B, W)
    if form == "exact":
        fn = collapse.collapse
    else:
        def fn(*a):
            return collapse.collapse_hashed(*a, weak_hash=form == "weak",
                                            unit_counts=form == "unit")
    want = fn(*ops)
    got = fn(*(t.to(dev) for t in ops))
    for g, w in zip(got, want):
        if g is None:
            assert w is None
            continue
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    if form == "weak" and B > 1:
        assert bool(got[5])


@pytest.mark.parametrize("env", [{}, {"FASTX_COLLAPSE_EXACT": "1"},
                                 {"FASTX_COLLAPSE_WEAK_HASH": "1"}])
def test_collapse_batch_and_cli_on_card_match_cpu(dev, env, monkeypatch):
    from fastx_toolkit_tpu_torch.cli.tools import fastx_collapser
    from fastx_toolkit_tpu_torch.ops import collapse
    from fastx_toolkit_tpu_torch.synth import synth_collapse_lane_bytes

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(3)
    bases = rng.choice(ALPHA, (30, 64))[rng.integers(0, 30, 8000)]
    counts = rng.integers(1, 4, 8000).astype(np.int32)
    for g, w in zip(collapse.collapse_batch(bases, counts, dev),
                    collapse.collapse_batch(bases, counts,
                                            torch.device("cpu"))):
        assert np.array_equal(g, w)
    monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", "200000")
    monkeypatch.setenv("FASTX_COLLAPSE_PATH", "device")
    data = synth_collapse_lane_bytes(20000, pool=2000, seed=5)
    got = _cli_run(fastx_collapser, ["-v"], data, "cuda", monkeypatch)
    want = _cli_run(fastx_collapser, ["-v"], data, "cpu", monkeypatch)
    monkeypatch.setenv("FASTX_COLLAPSE_PATH", "host")
    host = _cli_run(fastx_collapser, ["-v"], data, "cpu", monkeypatch)
    assert got == want == host and want[0] == 0


@pytest.mark.parametrize("tool,argv", [
    ("fastq_quality_trimmer", ["-Q", "33", "-t", "20", "-l", "10", "-v"]),
    ("fastx_trimmer", ["-Q", "33", "-f", "3", "-l", "40", "-v"]),
    ("fastx_reverse_complement", ["-Q", "33", "-v"]),
])
def test_per_read_classic_path_on_card_matches_cpu(dev, tool, argv,
                                                   monkeypatch):
    """A per-read tool with FASTX_LINEPATH=off keeps its tensors on the
    card, and its output equals the CPU run and the default engine's."""
    import importlib

    from fastx_toolkit_tpu_torch.ops import transforms

    mod = importlib.import_module(
        "fastx_toolkit_tpu_torch.cli.tools." + tool)
    fn = {"fastq_quality_trimmer": "quality_trimmer",
          "fastx_trimmer": "trimmer",
          "fastx_reverse_complement": "reverse_complement"}[tool]
    seen = []
    real = getattr(transforms, fn)
    monkeypatch.setattr(transforms, fn,
                        lambda *a, **k: seen.append(a[0].device.type)
                        or real(*a, **k))
    monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", "100000")
    data = _lane(3000, seed=17)
    monkeypatch.setenv("FASTX_LINEPATH", "off")
    got = _cli_run(mod, argv, data, "cuda", monkeypatch)
    assert len(seen) >= 3 and set(seen) == {"cuda"}
    want = _cli_run(mod, argv, data, "cpu", monkeypatch)
    monkeypatch.delenv("FASTX_LINEPATH")
    default = _cli_run(mod, argv, data, "cuda", monkeypatch)
    assert got == want == default and want[0] == 0


def _barcode_operands(seed, B, L, K, blen, partial):
    """Reads over ACGTN, every third with a barcode at either end, lengths
    0..L (a tenth below ``blen``); ``K`` barcodes, the last a repeat of the
    first (a tie on every read), each followed by its ``partial`` trimmed
    variants."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ALPHA[:4], (K, blen))
    base[-1] = base[0]
    rows, lens, pens = [], [], []
    for k in range(K):
        for p in range(partial + 1):
            rows.append(np.concatenate([base[k][p:], np.zeros(p, np.uint8)]))
            lens.append(blen - p)
            pens.append(p)
    bases = rng.choice(ALPHA, (B, L), p=[0.24, 0.24, 0.24, 0.24, 0.04])
    lengths = rng.integers(blen, L + 1, B)
    short = rng.random(B) < 0.1
    lengths[short] = rng.integers(0, blen, int(short.sum()))
    tagged = np.arange(0, B, 3)
    bases[tagged, :blen] = base[rng.integers(0, K, len(tagged))]
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return [torch.from_numpy(a) for a in (
        bases.astype(np.uint8), lengths.astype(np.int32),
        np.stack(rows).astype(np.uint8), np.array(lens, np.int32),
        np.array(pens, np.int32))]


@pytest.mark.parametrize("bol", [True, False])
@pytest.mark.parametrize("B,L,K,blen,partial", [
    (300_000, 128, 24, 6, 0), (5000, 64, 12, 8, 2), (1, 32, 2, 5, 1),
])
def test_barcode_match_on_card_matches_cpu(dev, bol, B, L, K, blen, partial):
    """The matcher on cuda tensors against the same function on CPU
    tensors, across its row chunks, with ties and short reads."""
    from fastx_toolkit_tpu_torch.ops import transforms

    ops = _barcode_operands(B + L + K, B, L, K, blen, partial)
    got = transforms.barcode_match(*(a.to(dev) for a in ops), bol=bol,
                                   barcodes_length=blen)
    want = transforms.barcode_match(*ops, bol=bol, barcodes_length=blen)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), w)
    assert not (want[0] >= (K - 1) * (partial + 1)).any()


@pytest.mark.parametrize("bol,argv", [
    (True, ["--bol", "--mismatches", "1"]),
    (False, ["--eol", "--partial", "1", "--mismatches", "1"]),
])
def test_barcode_splitter_on_card_matches_cpu(dev, bol, argv, tmp_path,
                                              monkeypatch):
    """The splitter with FASTX_TORCH_DEVICE=cuda: its matcher called once,
    on cuda tensors, and its files and summary equal the CPU run's."""
    from fastx_toolkit_tpu_torch.ops import transforms
    from fastx_toolkit_tpu_torch.scripts import barcode_splitter
    from fastx_toolkit_tpu_torch.synth import synth_barcode_lane_bytes

    lane, bcfile = synth_barcode_lane_bytes(20000, 100, bol=bol)
    (tmp_path / "bc.txt").write_bytes(bcfile)
    seen = []
    real = transforms.barcode_match
    monkeypatch.setattr(transforms, "barcode_match",
                        lambda *a, **k: seen.append(a[0].device.type)
                        or real(*a, **k))
    runs = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setenv("FASTX_TORCH_DEVICE", device)
        out_dir = tmp_path / device
        out_dir.mkdir()
        out, err = io.StringIO(), io.StringIO()
        rc = barcode_splitter.main_io(
            ["--bcfile", str(tmp_path / "bc.txt"), "--prefix",
             str(out_dir) + "/", *argv], io.BytesIO(lane), out, err)
        runs[device] = (rc, out.getvalue().replace(str(out_dir), "D"),
                        err.getvalue(),
                        {f.name: f.read_bytes() for f in out_dir.iterdir()})
    assert seen == ["cuda", "cpu"]
    assert runs["cuda"] == runs["cpu"] and runs["cpu"][0] == 0
    assert len(runs["cpu"][3]) == 25

"""The port's own host codec against the JAX package's: the lane
generator, FASTA/FASTQ parse and render, raw-line framing and the native
float32 clipper give identical results; the native library the port
loads is built from its own copy of the C++ codec."""

import os
import re

import numpy as np
import pytest

import bench
from fastx_toolkit_tpu.core import codec as ref_codec
from fastx_toolkit_tpu.core import native as ref_native
from fastx_toolkit_tpu.core.errors import FastxError as RefFastxError
from fastx_toolkit_tpu_torch import synth
from fastx_toolkit_tpu_torch.core import codec, native
from fastx_toolkit_tpu_torch.core.errors import FastxError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "galaxy", "test-data")
FIXTURES = sorted(f for f in os.listdir(TD)
                  if f.endswith((".fastq", ".fasta")))

needs_native = pytest.mark.skipif(
    native.LIB is None or ref_native.LIB is None,
    reason="native codec unavailable")


@pytest.mark.parametrize("n,read_len,seed", [(300, 100, 42), (200, 150, 7)])
def test_synth_lane_matches_bench(n, read_len, seed):
    assert synth.synth_lane_bytes(n, read_len, seed=seed) == \
        bench.synth_lane_bytes(n, read_len, seed=seed)


def test_small_rna_lane_parses():
    data = synth.synth_small_rna_lane_bytes(500, 50, seed=3)
    batch = codec.parse(data, filetype=codec.FASTQ_ONLY)
    assert len(batch) == 500
    assert (batch.lengths < 50).any() and (batch.bases == ord("N")).any()
    assert data.count(synth.SMALL_RNA_ADAPTER[:12]) > 300


def _parse_both(data, **kw):
    out = []
    for mod, err in ((ref_codec, RefFastxError), (codec, FastxError)):
        try:
            out.append(mod.parse(data, **kw))
        except err as e:
            out.append(str(e))
    return out


def _render(batch, mod, q_offset):
    return mod.render(batch, out_fastq=batch.is_fastq,
                      ascii_qual=batch.qual_ascii if batch.is_fastq else True,
                      q_offset=q_offset)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_parse_and_render_match_reference_on_fixtures(fixture):
    with open(os.path.join(TD, fixture), "rb") as fh:
        data = fh.read()
    for q_offset in (33, 64):
        ref, got = _parse_both(data, q_offset=q_offset, allow_u=True)
        if isinstance(ref, str):
            assert got == ref
            continue
        for f in ("bases", "quals", "lengths", "counts"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert got.names.to_list() == ref.names.to_list()
        assert _render(got, codec, q_offset) == _render(ref, ref_codec,
                                                        q_offset)


@needs_native
def test_frame_and_render_lines_match_reference_on_a_lane():
    data = synth.synth_lane_bytes(400, 90, seed=11)
    fr, rf = codec.frame_fastq_fast(data), ref_codec.frame_fastq_fast(data)
    for f in ("seq_starts", "seq_lens", "qual_starts", "name_starts",
              "name_lens"):
        np.testing.assert_array_equal(getattr(fr, f), getattr(rf, f))
    rng = np.random.default_rng(2)
    new_len = rng.integers(0, 91, len(fr)).astype(np.int32)
    keep = (rng.random(len(fr)) < 0.8).astype(np.uint8)
    outs = [mod.render_lines(
        f.buf, f.name_starts, f.name_lens, f.seq_starts, f.qual_starts,
        f.name2_starts, f.name2_lens, new_len, keep, out_fastq=True,
        q_offset=33, mask_thr=20) for mod, f in ((native, fr),
                                                 (ref_native, rf))]
    assert outs[0] == outs[1] and len(outs[0]) > 10000


@needs_native
def test_clip_float_matches_reference():
    rng = np.random.default_rng(4)
    B, L = 300, 60
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L),
                       p=[0.22] * 4 + [0.12])
    ad = b"CTGTAGGCACCATCAAT"
    for i in range(0, B, 2):
        pos = int(rng.integers(0, L - 5))
        seg = np.frombuffer(ad, np.uint8)[:L - pos]
        bases[i, pos:pos + len(seg)] = seg
    lengths = rng.integers(0, L + 1, B).astype(np.int64)
    got = native.clip_float(bases, lengths, ad)
    ref = ref_native.clip_float(bases, lengths, ad)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _code_lines(path):
    """The C++ source without its comments: the code the compiler sees."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return [ln for ln in (re.sub(r"//.*", "", x).rstrip()
                          for x in text.splitlines()) if ln]


@needs_native
def test_native_library_is_the_ports_own_build():
    pkg = os.path.join(ROOT, "fastx_toolkit_tpu_torch")
    assert native._SRC == os.path.join(pkg, "native", "fastx_codec.cpp")
    assert os.path.realpath(native.LIB._name) == os.path.realpath(
        os.path.join(pkg, "_build", "libfastx_codec.so"))
    assert _code_lines(native._SRC) == _code_lines(
        os.path.join(ROOT, "native", "fastx_codec.cpp"))


def _n_rich(seed, B, L, adapter):
    """Reads rich in N with the adapter spiked in: many exact float ties."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L),
                       p=[0.175] * 4 + [0.3])
    ad = np.frombuffer(adapter, np.uint8)
    for i in range(0, B, 2):
        pos = int(rng.integers(0, L - 4))
        seg = ad[:L - pos].copy()
        seg[rng.random(len(seg)) < 0.2] = ord("N")
        bases[i, pos:pos + len(seg)] = seg
    lengths = rng.integers(0, L + 1, B).astype(np.int64)
    return bases, lengths


@pytest.mark.parametrize("adapter", [b"CTGTAGGCACCATCAAT", b"CTNNAGGCAC"])
def test_align_batch_float32_matches_reference(adapter):
    from fastx_toolkit_tpu.kernels.align import (
        align_batch_float32 as ref_float32,
    )
    from fastx_toolkit_tpu_torch.kernels.align import align_batch_float32

    bases, lengths = _n_rich(6 + len(adapter), 96, 40, adapter)
    want = ref_float32(bases, lengths, adapter)
    got = align_batch_float32(bases, lengths, adapter)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@needs_native
def test_clip_decide_np_without_native_matches_native(monkeypatch):
    from fastx_toolkit_tpu_torch.engine import hostfix

    adapter = b"CTGTAGGCACCATCAAT"
    bases, lengths = _n_rich(9, 120, 45, adapter)
    kw = dict(min_length=5, keep_delta=0, discard_non_clipped=False,
              discard_clipped=False, keep_n=False, show_adapter_only=False,
              min_adapter_len=0)
    want = hostfix.clip_decide_np(bases, lengths, adapter, **kw)
    monkeypatch.setattr(native, "LIB", None)
    got = hostfix.clip_decide_np(bases, lengths, adapter, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[2] != 0).any() and (want[2] == 0).any()

"""The port's classic (unpacked) decisions path against the JAX package's,
exactly:

* ``pipeline_body`` / ``decisions_pipeline`` and ``packed_pipeline_body``
  (2-bit and 4-bit uploads) vs the reference bodies over the five configs
  of tests/test_packed_fast.py plus a 40-base and an 80-base adapter;
* ``packed_decisions_pipeline`` routing a 40-base adapter to the wide
  packed DP (K3's route) and an 80-base adapter to the unpacking body
  (K4's route), decision-identical to the reference;
* the line engine (``stream_pipeline_lines(device="cpu")``) on lanes
  whose classic chunks (numeric qualities, U bases) interleave with fast
  chunks at a small ``chunk_rows``, with the
  headline adapter and the 33-base TruSeq adapter: equal output bytes and
  counts; a lowercase chunk raises the reference's exact error after the
  pending spans.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_lines import _lane
from test_torch_pipeline import CONFIGS, RefConfig, _chunk

from fastx_toolkit_tpu.cli.tools._shared import BatchReader as RefReader
from fastx_toolkit_tpu.core.errors import FastxError
from fastx_toolkit_tpu.engine import lines as ref_lines
from fastx_toolkit_tpu.engine import pipeline as ref_pipeline
from fastx_toolkit_tpu_torch.cli.tools._shared import BatchReader
from fastx_toolkit_tpu_torch.core import codec, native
from fastx_toolkit_tpu_torch.core.errors import FastxError as PortFastxError
from fastx_toolkit_tpu_torch.engine import lines as port_lines
from fastx_toolkit_tpu_torch.engine import pipeline as port_pipeline

ADAPTER = b"CTGTAGGCACCATCAAT"
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
WIDE40 = (TRUSEQ * 2)[:40]
WIDE80 = (TRUSEQ * 3)[:80]
ALL_CONFIGS = dict(CONFIGS, wide40=RefConfig(adapter=WIDE40),
                   wide80=RefConfig(adapter=WIDE80))


def _port_cfg(cfg):
    return port_pipeline.config_from_reference(cfg)


def _ascii_batch(seed, adapter, B=64, L=48, alphabet=b"ACGTN"):
    rng = np.random.default_rng(seed)
    bases, quals, lengths = _chunk(rng, B, L, True, adapter=adapter[:L - 6])
    if alphabet != b"ACGTN":
        lower = rng.random((B, L)) < 0.1
        alt = rng.choice(np.frombuffer(alphabet, np.uint8), size=(B, L))
        bases = np.where(lower, alt, bases).astype(np.uint8)
    pad = np.arange(L)[None, :] >= lengths[:, None].astype(np.int32)
    bases[pad] = 0
    return bases, quals, lengths.astype(np.int32)


@pytest.mark.parametrize("cfg_name", sorted(ALL_CONFIGS))
def test_pipeline_body_matches_reference(cfg_name):
    cfg = ALL_CONFIGS[cfg_name]
    b, q, l = _ascii_batch(sorted(ALL_CONFIGS).index(cfg_name),  # noqa: E741
                           cfg.adapter, alphabet=b"ACGTNacgtU")
    ref = ref_pipeline.pipeline_body(b, q, l, np.ones(len(l), np.int32), cfg,
                                     tie_flag=True)
    rb, rq, rl, rk, _count, rf = (np.asarray(x) for x in ref)
    got = port_pipeline.pipeline_body(
        *(torch.from_numpy(a) for a in (b, q, l)), _port_cfg(cfg),
        tie_flag=True)
    for name, g, r in zip(("bases", "quals", "l", "keep", "fragile"), got,
                          (rb, rq, rl, rk, rf)):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    dl, dk, df = port_pipeline.decisions_pipeline(
        _port_cfg(cfg), b, q, l, device="cpu", tie_flag=True)
    np.testing.assert_array_equal(dl.numpy(), rl)
    np.testing.assert_array_equal(dk.numpy(), rk)
    np.testing.assert_array_equal(df.numpy(), rf)


@pytest.mark.parametrize("cfg_name,two_bit", [
    ("headline", True), ("headline", False), ("config4", False),
    ("config1", True), ("wide80", True),
])
def test_packed_pipeline_body_matches_reference(cfg_name, two_bit):
    cfg = ALL_CONFIGS[cfg_name]
    alphabet = b"ACGTN" if two_bit else b"ACGTNacgtnU"
    b, q, l = _ascii_batch(11, cfg.adapter, L=44, alphabet=alphabet)  # noqa: E741
    L = b.shape[1]
    if two_bit:
        b_pack = np.where(b == 0, ord("A"), b).astype(np.uint8)
        b4, planes = ref_pipeline.pack_batch2(b_pack, q, cfg, n_plane=True)
        p4, pplanes = port_pipeline.pack_batch2(b_pack, q, _port_cfg(cfg),
                                                n_plane=True)
    else:
        b4, planes = ref_pipeline.pack_batch(b, q, cfg)
        p4, pplanes = port_pipeline.pack_batch(b, q, _port_cfg(cfg))
    np.testing.assert_array_equal(p4, b4)
    np.testing.assert_array_equal(pplanes, planes)
    ref = ref_pipeline.packed_pipeline_body(
        b4, planes, l, None, cfg, seq_len=L, two_bit=two_bit, tie_flag=True)
    rl, rk, _count, rf = (np.asarray(x) for x in ref)
    gl, gk, gf = port_pipeline.packed_pipeline_body(
        torch.from_numpy(b4), torch.from_numpy(planes), torch.from_numpy(l),
        _port_cfg(cfg), seq_len=L, two_bit=two_bit, tie_flag=True)
    np.testing.assert_array_equal(gl.numpy(), rl, err_msg="l")
    np.testing.assert_array_equal(gk.numpy(), rk, err_msg="keep")
    np.testing.assert_array_equal(gf.numpy(), rf, err_msg="fragile")


@pytest.mark.parametrize("adapter,fast", [(WIDE40, True), (WIDE80, False)])
def test_packed_decisions_route_wide_adapters(adapter, fast, monkeypatch):
    """A 40-base adapter stays on the fully-packed body (K3's route), an
    80-base one takes the unpacking body (K4's route); both decide as the
    reference does."""
    monkeypatch.delenv("FASTX_TPU_PACKED_DECIDE", raising=False)
    cfg = RefConfig(adapter=adapter)
    rng = np.random.default_rng(len(adapter))
    bases, quals, lengths = _chunk(rng, 96, 60, True, adapter=adapter[:50])
    b2, planes = ref_pipeline.pack_batch2(bases, quals, cfg, n_plane=True)
    ref = ref_pipeline.packed_decisions_pipeline(
        cfg, two_bit=True, has_n_plane=True, tie_flag=True)
    rl, rk, _count, rf = (np.asarray(x) for x in ref(b2, planes, lengths))
    pcfg = _port_cfg(cfg)
    assert port_pipeline.packed_fast_ok(pcfg, 60) == fast
    gl, gk, gf = port_pipeline.packed_decisions_pipeline(
        pcfg, b2, planes, lengths, has_n_plane=True, device="cpu",
        tie_flag=True)
    np.testing.assert_array_equal(gl.numpy(), rl)
    np.testing.assert_array_equal(gk.numpy(), rk)
    np.testing.assert_array_equal(gf.numpy(), rf)
    assert rk.any() and rf.any()


def _mixed_lane(n, seed, adapter, lower=False):
    """_lane's reads with classic chunks spread through the stream:
    numeric-quality records and reads carrying U (or, with ``lower``,
    a lowercase read)."""
    data = _lane(n, seed, n_after=n // 2, numeric_at={n // 5, n // 2 + 7})
    recs = data.split(b"\n@")
    for i in (n // 3, (3 * n) // 4):
        head, seq, rest = recs[i].split(b"\n", 2)
        seq = seq.lower() if lower else seq.replace(b"T", b"U")
        recs[i] = b"\n".join((head, seq, rest))
    data = b"\n@".join(recs)
    if adapter != ADAPTER:
        data = data.replace(ADAPTER, adapter[:len(ADAPTER)])
    return data


def _runs(data, ref_cfg, chunk_rows, block_bytes, engines=None):
    """The reference's and the port's line engine over ``data`` with a
    reader that admits U: ``(ref, port)`` results, each ``(n_in, n_out,
    bytes)`` or the FastxError text."""
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    out = []
    for Reader, mod, cfg, kw in (
            (RefReader, ref_lines, ref_cfg,
             dict(engines=ref_lines.LineEngines(ref_cfg))),
            (BatchReader, port_lines, port_pipeline.config_from_reference(
                ref_cfg), dict(device="cpu", engines=engines))):
        reader = Reader(None, args, filetype=codec.FASTQ_ONLY, allow_u=True,
                        block_bytes=block_bytes, stream=io.BytesIO(data))
        w = []
        try:
            n_in, n_out, _ = mod.stream_pipeline_lines(
                reader, cfg, out_fastq=True, q_offset=33, write=w.append,
                chunk_rows=chunk_rows, **kw)
            out.append((n_in, n_out, b"".join(w)))
        except (FastxError, PortFastxError) as e:
            out.append(str(e))
    return out


@pytest.mark.skipif(native.LIB is None, reason="native codec unavailable")
@pytest.mark.parametrize("adapter", [ADAPTER, TRUSEQ])
def test_stream_with_classic_chunks_matches_reference(adapter):
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    ref_cfg = PipelineConfig(adapter=adapter)
    data = _mixed_lane(400, 31, adapter)
    assert data.count(b"\n+\n") == 400 and b"U" in data
    eng = port_lines.LineEngines(_port_cfg(ref_cfg), "cpu")
    ref, got = _runs(data, ref_cfg, 48, 4096, engines=eng)
    assert got == ref
    assert ref[0] == 400 and 0 < ref[1] < 400
    assert eng.fragile_rows > 0


@pytest.mark.skipif(native.LIB is None, reason="native codec unavailable")
def test_stream_lowercase_chunk_raises_reference_error():
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    data = _mixed_lane(200, 32, ADAPTER, lower=True)
    ref, got = _runs(data, PipelineConfig(), 32, 4096)
    assert isinstance(ref, str) and "invalid nucleotide" in ref
    assert got == ref

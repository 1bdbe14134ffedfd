"""The port's packed decisions body against the JAX package's
``packed_decisions_pipeline(two_bit=True, tie_flag=True)``: final lengths,
keep masks and tie_fragile flags, exactly, for the five configs of
tests/test_packed_fast.py with and without N, each carried across with
``config_from_reference``.

At B=256 the reference's own gate routes these batches to its unpack
body (its fast body needs B % 1024 == 0), which its tests hold
decision-identical to the fast body; ``test_headline_vs_reference_fast_body``
runs one B=1024 batch through the reference's fast body itself (its P12
and counts Pallas kernels in interpret mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.engine import pipeline as ref_pipeline
from fastx_toolkit_tpu.engine.pipeline import pack_batch2
from fastx_toolkit_tpu_torch.engine import pipeline as port_pipeline

ADAPTER = b"CTGTAGGCACCATCAAT"
RefConfig = ref_pipeline.PipelineConfig

CONFIGS = {
    "headline": RefConfig(adapter=ADAPTER),
    "config1": RefConfig(
        adapter=ADAPTER, trim_last=80, with_filter=False, with_qtrim=False,
        with_mask=False, with_clip=False, with_artifacts=False,
        to_fasta_discard_n=True,
    ),
    "config2": RefConfig(adapter=ADAPTER, with_clip=False,
                         with_artifacts=False),
    "config4": RefConfig(
        adapter=ADAPTER, with_filter=False, with_qtrim=False,
        with_mask=False, clip_keep_n=False, clip_minlen=15,
    ),
    "artifacts_only": RefConfig(
        adapter=ADAPTER, with_filter=False, with_qtrim=False,
        with_mask=False, with_clip=False,
    ),
}


def _chunk(rng, B, L, with_n: bool, adapter=ADAPTER):
    """tests/test_packed_fast.py::_chunk."""
    p = [0.24, 0.24, 0.24, 0.24, 0.04] if with_n else [0.25] * 4
    alpha = np.frombuffer(b"ACGTN" if with_n else b"ACGT", np.uint8)
    bases = rng.choice(alpha, size=(B, L), p=p)
    pos = rng.integers(0, max(1, L - 5), B)
    for j, ch in enumerate(adapter):
        m = (rng.random(B) < 0.35) & (pos + j < L)
        bases[m, (pos + j)[m]] = ch
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int16)
    cols = np.arange(L)[None, :]
    quals[cols >= lengths[:, None].astype(np.int32)] = 0
    bases[cols >= lengths[:, None].astype(np.int32)] = ord("A")
    return bases, quals, lengths


def _compare(cfg, b2, planes, lengths, with_n, monkeypatch):
    monkeypatch.setenv("FASTX_TPU_PACKED_DECIDE", "force")
    monkeypatch.delenv("FASTX_TPU_NO_PACKED_DECIDE", raising=False)
    ref = ref_pipeline.packed_decisions_pipeline(
        cfg, two_bit=True, has_n_plane=with_n, tie_flag=True)
    rl, rk, _count, rf = (np.asarray(x) for x in ref(b2, planes, lengths))
    port_cfg = port_pipeline.config_from_reference(cfg)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    gl, gk, gf = port_pipeline.packed_decisions_pipeline(
        port_cfg, b2, planes, lengths, has_n_plane=with_n, device="cpu",
        tie_flag=True)
    np.testing.assert_array_equal(gl.numpy(), rl, err_msg="l")
    np.testing.assert_array_equal(gk.numpy(), rk, err_msg="keep")
    np.testing.assert_array_equal(gf.numpy(), rf, err_msg="fragile")
    return rk, rf


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("with_n", [False, True])
def test_packed_decisions_match_reference(cfg_name, with_n, monkeypatch):
    cfg = CONFIGS[cfg_name]
    rng = np.random.default_rng(sorted(CONFIGS).index(cfg_name) * 2 + with_n)
    bases, quals, lengths = _chunk(rng, 256, 72, with_n)
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=with_n)
    keep, _ = _compare(cfg, b2, planes, lengths, with_n, monkeypatch)
    assert keep.any()


def test_headline_vs_reference_fast_body(monkeypatch):
    cfg = CONFIGS["headline"]
    rng = np.random.default_rng(99)
    bases, quals, lengths = _chunk(rng, 1024, 72, True)
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=True)
    _keep, fragile = _compare(cfg, b2, planes, lengths, True, monkeypatch)
    assert fragile.any()


def test_fast_body_respects_trim_boundaries(monkeypatch):
    """Odd lengths around the plane-byte boundaries (8/16) through the
    bit-trick quality trimmer (tests/test_packed_fast.py:85-107)."""
    cfg = CONFIGS["config2"]
    rng = np.random.default_rng(7)
    B, L = 256, 24
    bases, quals, lengths = _chunk(rng, B, L, False)
    lengths[:] = np.tile([0, 1, 7, 8, 9, 15, 16, 17, 23, 24, 3, 20, 24, 24,
                          24, 24], B // 16).astype(np.int16)
    cols = np.arange(L)[None, :]
    quals[cols >= lengths[:, None].astype(np.int32)] = 0
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=False)
    _compare(cfg, b2, planes, lengths, False, monkeypatch)


def test_outside_the_gate_raises():
    """Chunks outside K1's gate decide as the reference does: a 32-base
    adapter (the wide packed DP, K3's route), an adapter outside ACGTN
    (the unpacking body, K4's route) and reads of up to 600 bp (K3's
    route); with the stats reduction the decisions and the per-cycle
    counts equal the reference's ``pipeline_body`` with ``with_stats``."""
    for adapter, L in ((b"ACGT" * 8, 72), (b"CTGTAGGCACCATCAAU", 72),
                       (ADAPTER, 600)):
        cfg = RefConfig(adapter=adapter)
        rng = np.random.default_rng(L + len(adapter))
        bases, quals, lengths = _chunk(rng, 24, L, True, adapter=adapter)
        lengths[0] = L
        b2, planes = pack_batch2(bases, quals, cfg, n_plane=True)
        ref = ref_pipeline.packed_pipeline_body(
            b2, planes, lengths, None, cfg, seq_len=L, two_bit=True,
            has_n_plane=True, tie_flag=True)
        rl, rk, _count, rf = (np.asarray(x) for x in ref)
        gl, gk, gf = port_pipeline.packed_decisions_pipeline(
            port_pipeline.config_from_reference(cfg), b2, planes, lengths,
            has_n_plane=True, device="cpu", tie_flag=True, seq_len=L)
        np.testing.assert_array_equal(gl.numpy(), rl, err_msg="l")
        np.testing.assert_array_equal(gk.numpy(), rk, err_msg="keep")
        np.testing.assert_array_equal(gf.numpy(), rf, err_msg="fragile")
    cfg = RefConfig(adapter=ADAPTER, with_stats=True)
    rng = np.random.default_rng(139)
    bases, quals, lengths = _chunk(rng, 24, 100, True)
    counts = rng.integers(1, 4, 24).astype(np.int32)
    ref = ref_pipeline.pipeline_body(bases, quals, lengths.astype(np.int32),
                                     counts, cfg)
    got = port_pipeline.pipeline_body(
        *(torch.from_numpy(a) for a in (bases, quals,
                                        lengths.astype(np.int32))),
        port_pipeline.config_from_reference(cfg),
        counts=torch.from_numpy(counts))
    for name, g, r in zip(("l", "keep", "count"), got[2:4] + got[5:],
                          (ref[2], ref[3], ref[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(np.asarray(ref[4]).sum()) > 0
    b2 = np.zeros((4, 26), np.uint8)
    planes = np.zeros((4, 3, 13), np.uint8)
    lengths = np.full(4, 100, np.int16)
    # without the clipper the DP's read-length bound does not apply
    l, keep, _ = port_pipeline.packed_decisions_pipeline(
        port_pipeline.PipelineConfig(with_clip=False, with_artifacts=False),
        b2, planes, lengths,
        has_n_plane=False, device="cpu", seq_len=600)
    assert keep.all()

"""The port's clipper ops against the JAX package's, exactly:
``clip_batch`` over combinations of every clipper flag (``-d -c -C -k -M
-n``) comparing the clipped batch, new lengths, write mask, categories
and tie_fragile flags; the legacy stale-matrix emulation with its carry
across chunks; and the float32 host re-decision with the legacy view."""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.engine import hostfix as ref_hostfix
from fastx_toolkit_tpu.ops import clipper as ref_clipper
from fastx_toolkit_tpu_torch.engine import hostfix as port_hostfix
from fastx_toolkit_tpu_torch.ops import clipper as port_clipper

ADAPTER = b"CTGTAGGCACCATCAAT"
FLAGS = dict(adapter=ADAPTER, min_length=5, keep_delta=0,
             discard_non_clipped=False, discard_clipped=False, keep_n=False,
             show_adapter_only=False, min_adapter_len=0)


def _batch(seed, B=64, L=48):
    """N-bearing reads, half with a noisy adapter copy (some at position
    0: adapter-only reads), variable lengths, PAD beyond each read."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    bases = rng.choice(alpha, size=(B, L), p=[0.235] * 4 + [0.06])
    ad = np.frombuffer(ADAPTER, np.uint8)
    for i in range(0, B, 2):
        pos = 0 if i % 8 == 0 else int(rng.integers(1, L - 4))
        seg = ad[:L - pos].copy()
        seg[rng.integers(0, len(seg))] = rng.choice(alpha[:4])
        bases[i, pos:pos + len(seg)] = seg
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:8] = L
    pad = np.arange(L)[None, :] >= lengths[:, None]
    bases[pad] = 0
    quals[pad] = 0
    return bases, quals, lengths


@pytest.mark.parametrize("kw", [
    dict(),
    dict(keep_n=True),
    dict(keep_delta=3 + len(ADAPTER), discard_clipped=True),
    dict(discard_non_clipped=True, min_length=15),
    dict(show_adapter_only=True, keep_n=True),
    dict(min_adapter_len=8, discard_non_clipped=True),
])
def test_clip_batch_matches_reference(kw):
    flags = dict(FLAGS, **kw)
    b, q, l = _batch(3)  # noqa: E741
    ref = ref_clipper.clip_batch(b, q, l, **flags, tie_flag=True)
    got = port_clipper.clip_batch(*(torch.from_numpy(a) for a in (b, q, l)),
                                  **flags, tie_flag=True)
    for name, g, r in zip(("bases", "quals", "new_len", "write", "cat",
                           "fragile"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    cats = set(np.asarray(ref[4]).tolist())
    assert len(cats) > 1


def _legacy_chunks(seed):
    rng = np.random.default_rng(seed)
    b, _q, l = _batch(seed, B=40, L=30)  # noqa: E741
    l[:] = rng.integers(0, 31, len(l))  # widths rise and fall
    b[np.arange(30)[None, :] >= l[:, None]] = 0
    return b, l


def test_legacy_effective_query_with_carry_matches_reference():
    b1, l1 = _legacy_chunks(5)
    b2, l2 = _legacy_chunks(6)
    b2, l2 = b2[:, :20], np.minimum(l2, 20)  # a narrower second chunk
    carry_r = carry_p = None
    for b, l in ((b1, l1), (b2, l2)):  # noqa: E741
        er, wr, carry_r = ref_clipper.legacy_effective_query(b, l, carry_r)
        ep, wp, carry_p = port_clipper.legacy_effective_query(b, l, carry_p)
        np.testing.assert_array_equal(ep, er)
        np.testing.assert_array_equal(wp, wr)
        np.testing.assert_array_equal(carry_p[0], carry_r[0])
        assert carry_p[1] == carry_r[1]


def test_clip_batch_with_legacy_view_matches_reference():
    b, q, l = _batch(7)  # noqa: E741
    eff, widths, _ = ref_clipper.legacy_effective_query(b, l)
    ref = ref_clipper.clip_batch(b, q, l, **FLAGS, align_bases=eff,
                                 align_lengths=widths, tie_flag=True)
    got = port_clipper.clip_batch(
        *(torch.from_numpy(a) for a in (b, q, l)), **FLAGS,
        align_bases=torch.from_numpy(eff),
        align_lengths=torch.from_numpy(widths), tie_flag=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("legacy", [False, True])
def test_clip_decide_np_matches_reference(legacy):
    from fastx_toolkit_tpu_torch.core import native

    if native.LIB is None:
        pytest.skip("native codec unavailable")
    b, _q, l = _batch(9)  # noqa: E741
    kw = dict(FLAGS, discard_non_clipped=True, min_adapter_len=3)
    if legacy:
        eff, widths, _ = ref_clipper.legacy_effective_query(b, l)
        kw.update(align_bases=eff, align_lengths=widths)
    adapter = kw.pop("adapter")
    ref = ref_hostfix.clip_decide_np(b, l, adapter, **kw)
    got = port_hostfix.clip_decide_np(b, l, adapter, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

"""The port's ``ops/collapse.py`` against the JAX package's, tolerance 0:
the same seeded numpy words, counts and first-appearance indices go
through both, and every output is equal — the exact form, the hashed
form (its rolling hashes and its three-key sort recomputed here with jnp
and ``lax.sort``; ``unit_counts`` on and off; ``weak_hash`` forcing the
collision), ``collapse_batch`` (with and without ``FASTX_COLLAPSE_EXACT``,
and under ``FASTX_COLLAPSE_WEAK_HASH``, where the exact re-run must be
taken) and the host-side ``final_order``, ``ordinal_column`` and
``rank_count_column``.  Words with the top bit set exercise the signed
sort key; W = 1, 2 and 5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.ops import collapse as ref
from fastx_toolkit_tpu_torch.ops import collapse as port


def _inputs(seed, B, W, pool=23):
    """Rows drawn from a small pool of random full-range words (so about
    half the words have the top bit set), plus the two extreme rows."""
    rng = np.random.default_rng(seed)
    pool_words = rng.integers(0, 2**32, (pool, W), dtype=np.uint64)
    pool_words[0] = 0xFFFFFFFF
    pool_words[1] = 0
    words = pool_words[rng.integers(0, pool, B)].astype(np.uint32)
    counts = rng.integers(1, 6, B).astype(np.int32)
    first_idx = rng.permutation(B).astype(np.int32)
    return words, counts, first_idx


def _tensors(words, counts, first_idx):
    return (torch.from_numpy(words.view(np.int32)), torch.from_numpy(counts),
            torch.from_numpy(first_idx))


def _jax_hashes(words):
    """The reference's four rolling hashes (``collapse_hashed``'s loop)."""
    wu = jnp.asarray(words, jnp.uint32)
    B, W = wu.shape
    h1 = jnp.full(B, 0x811C9DC5, jnp.uint32)
    h2 = jnp.full(B, 0x9E3779B9, jnp.uint32)
    h3 = jnp.full(B, 0xC2B2AE35, jnp.uint32)
    h4 = jnp.full(B, 0x27D4EB2F, jnp.uint32)
    for w in range(W):
        col = wu[:, w]
        h1 = h1 * jnp.uint32(0x01000193) + col
        h1 = h1 ^ (h1 >> 15)
        h2 = h2 * jnp.uint32(0x85EBCA6B) + (col ^ jnp.uint32((w * 0x9E3779B9) & 0xFFFFFFFF))
        h2 = h2 ^ (h2 >> 13)
        h3 = h3 * jnp.uint32(0x9E3779B1) + (col ^ jnp.uint32((w * 0x632BE5AB) & 0xFFFFFFFF))
        h3 = h3 ^ (h3 >> 16)
        h4 = h4 * jnp.uint32(0x2545F491) + col
        h4 = h4 ^ (h4 >> 11)
    return h1, h2, h3, h4


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("W", [1, 2, 5])
def test_collapse_exact_matches_reference(W):
    words, counts, first_idx = _inputs(3 + W, 700, W)
    want = ref.collapse(words, counts, first_idx)
    got = port.collapse(*_tensors(words, counts, first_idx))
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        _eq(a, b)
    assert int(got[1].sum()) <= 23 + 2


@pytest.mark.parametrize("W", [1, 2, 5])
def test_rolling_hashes_and_three_key_sort_match_reference(W):
    words, counts, first_idx = _inputs(11 + W, 500, W)
    jh = _jax_hashes(words)
    th = port.rolling_hashes(torch.from_numpy(words.view(np.int32)))
    for a, b in zip(jh, th):
        _eq(a, b)
    assert any(int(np.asarray(h).max()) >= 2**31 for h in jh)
    # the three-key sort: lax.sort over (h1, h2, first_idx) carrying counts
    want = jax.lax.sort((jh[0], jh[1], jnp.asarray(first_idx),
                         jnp.asarray(counts)), num_keys=3)
    got = port.sort_by_hash(th[0], th[1], torch.from_numpy(first_idx),
                            torch.from_numpy(counts))
    for a, b in zip(want, got):
        _eq(a, b)


@pytest.mark.parametrize("unit_counts", [False, True])
@pytest.mark.parametrize("W", [1, 2, 5])
def test_collapse_hashed_matches_reference(W, unit_counts):
    words, counts, first_idx = _inputs(21 + W, 600, W)
    if unit_counts:
        counts = np.ones_like(counts)
    want = ref.collapse_hashed(words, counts, first_idx,
                               unit_counts=unit_counts)
    got = port.collapse_hashed(*_tensors(words, counts, first_idx),
                               unit_counts=unit_counts)
    assert want[0] is None and got[0] is None
    for a, b in zip(want[1:], got[1:]):
        _eq(a, b)
    assert not bool(got[5])


@pytest.mark.parametrize("W", [1, 2, 5])
def test_weak_hash_collides_as_in_reference(W):
    words, counts, first_idx = _inputs(31 + W, 400, W)
    want = ref.collapse_hashed(words, counts, first_idx, weak_hash=True)
    got = port.collapse_hashed(*_tensors(words, counts, first_idx),
                               weak_hash=True)
    for a, b in zip(want[1:], got[1:]):
        _eq(a, b)
    assert bool(want[5]) and bool(got[5])


def _batch(seed, B, L, pool=17):
    """Padded ASCII reads drawn from a pool (PAD 0 past each length)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, pool)
    seqs = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (pool, L))
    seqs[np.arange(L)[None, :] >= lens[:, None]] = 0
    pick = rng.integers(0, pool, B)
    return seqs[pick], pick


@pytest.mark.parametrize("env", [{}, {"FASTX_COLLAPSE_EXACT": "1"},
                                 {"FASTX_COLLAPSE_WEAK_HASH": "1"}])
@pytest.mark.parametrize("L,unit", [(3, True), (8, False), (37, True),
                                    (37, False)])
def test_collapse_batch_matches_reference(L, unit, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bases, _pick = _batch(40 + L, 500, L)
    rng = np.random.default_rng(L)
    counts = (np.ones(500, np.int32) if unit
              else rng.integers(1, 9, 500).astype(np.int32))
    exact_runs = []
    real_collapse = port.collapse
    monkeypatch.setattr(port, "collapse",
                        lambda *a: exact_runs.append(1) or real_collapse(*a))
    want = ref.collapse_batch(bases, counts)
    got = port.collapse_batch(bases, counts, torch.device("cpu"))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        _eq(a, b)
    # the exact form ran iff asked for or forced by the collision
    assert len(exact_runs) == (0 if not env else 1)


def test_collapse_batch_empty_matches_reference():
    bases = np.zeros((0, 32), np.uint8)
    counts = np.zeros(0, np.int32)
    for a, b in zip(ref.collapse_batch(bases, counts),
                    port.collapse_batch(bases, counts, torch.device("cpu"))):
        assert a.dtype == b.dtype and a.shape == b.shape == (0,)


def test_pack_words_matches_reference():
    bases, _ = _batch(5, 50, 13)
    assert np.array_equal(ref.pack_words(bases), port.pack_words(bases))


def test_host_columns_match_reference():
    rng = np.random.default_rng(9)
    counts = np.concatenate([rng.integers(1, 5, 300),
                             [9, 10, 99, 100, 999, 1000, 123456789]])
    first = rng.permutation(len(counts))
    assert np.array_equal(ref.final_order(counts, first),
                          port.final_order(counts, first))
    for a, b in zip(ref.rank_count_column(counts),
                    port.rank_count_column(counts)):
        assert np.array_equal(a, b)
    for start, n in [(0, 0), (0, 1), (0, 120), (95, 10), (999_990, 25)]:
        for a, b in zip(ref.ordinal_column(start, n),
                        port.ordinal_column(start, n)):
            assert np.array_equal(a, b)

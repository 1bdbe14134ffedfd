"""The port's packed counts (K2's CPU path) against the JAX package's
``packed_counts_pallas(interpret=True)``, exactly, with and without the N
plane, at odd lengths around the 8-, 16- and 32-column boundaries of the
packed words."""

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.engine.pipeline import PipelineConfig, _words_T, pack_batch2
from fastx_toolkit_tpu.kernels.counts_pallas import packed_counts_pallas
from fastx_toolkit_tpu_torch.kernels.counts_cuda import packed_counts

BOUNDARY_LENGTHS = [0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 70]


@pytest.mark.parametrize("with_nm", [False, True])
@pytest.mark.parametrize("L", [24, 70])
def test_packed_counts_matches_reference(with_nm, L):
    rng = np.random.default_rng(L * 2 + with_nm)
    B = 128
    alpha = np.frombuffer(b"ACGTN" if with_nm else b"ACGT", np.uint8)
    bases = rng.choice(alpha, size=(B, L))
    # homopolymer-rich rows so the max letter count varies
    bases[::5, : L // 2] = ord("A")
    bases[1::7, L // 3:] = ord("T")
    quals = rng.integers(2, 41, size=(B, L)).astype(np.int8)
    lens = [x for x in BOUNDARY_LENGTHS if x <= L]
    lengths = np.resize(np.asarray(lens, np.int32), B)
    lengths[len(lens):] = rng.integers(0, L + 1, B - len(lens))

    cfg = PipelineConfig(with_filter=False, with_qtrim=False)  # mask q20
    b2, planes = pack_batch2(bases, quals, cfg, n_plane=True)
    # effective-N plane: input N OR masked position
    nmb = planes[:, 0] | planes[:, 1]
    L32 = -(-L // 32) * 32
    b2w = np.asarray(_words_T(b2, L32 // 4))
    nmw = np.asarray(_words_T(nmb, L32 // 8)) if with_nm else None

    rw, rn = packed_counts_pallas(b2w, nmw, lengths, tile_b=B,
                                  interpret=True)
    gw, gn = packed_counts(
        torch.tensor(b2w.view(np.int32)),
        None if nmw is None else torch.tensor(nmw.view(np.int32)),
        torch.from_numpy(lengths))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw), err_msg="worst")
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn), err_msg="ncnt")
    if with_nm:
        assert np.asarray(rn).any()

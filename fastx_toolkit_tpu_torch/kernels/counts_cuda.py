"""K2: per-read base counts on the 2-bit packed upload.

Counterpart of ``fastx_toolkit_tpu/kernels/counts_pallas.py::
packed_counts_pallas``: over positions ``x < lengths`` (the post-clip
lengths in the pipeline), the largest single-letter A/C/G/T count
(``worst``, for the artifacts filter) and the effective-N count (a
position with its N-plane bit set counts as N, not as its letter).
:func:`packed_counts` launches ``csrc/packed_counts.cu`` for CUDA tensors
and runs :func:`packed_counts_plain` for CPU tensors; operands are those
of :mod:`.align_cuda`.
"""

from __future__ import annotations

import torch

from . import _build
from .align_cuda import check_operands, unpack_bits, unpack_codes

# kernel launches by packed_counts (reset it to 0 to count a run)
launches = 0


def packed_counts_plain(b2w, nmw, lengths):
    """The plain torch version of K2 on any device."""
    L_pad = b2w.shape[0] * 16
    codes = unpack_codes(b2w, L_pad)                              # [B, L_pad]
    valid = torch.arange(L_pad, device=b2w.device)[None, :] < lengths[:, None]
    if nmw is not None:
        is_n = unpack_bits(nmw, L_pad)
        letter = valid & ~is_n
        ncnt = (valid & is_n).sum(dim=1)
    else:
        letter = valid
        ncnt = torch.zeros(b2w.shape[1], dtype=torch.int64, device=b2w.device)
    worst = torch.stack([(letter & (codes == c)).sum(dim=1) for c in range(4)])
    return worst.max(dim=0).values.to(torch.int32), ncnt.to(torch.int32)


def packed_counts(b2w, nmw, lengths):
    """``(worst, ncnt)`` int32 ``[B]`` per read (see module docstring)."""
    global launches
    check_operands(b2w, nmw, lengths)
    if b2w.device.type == "cpu":
        return packed_counts_plain(b2w, nmw, lengths)
    if not b2w.is_cuda:
        raise ValueError("unsupported device %s" % b2w.device)
    lib = _build.library()
    W16, B = b2w.shape
    worst = torch.empty(B, dtype=torch.int32, device=b2w.device)
    ncnt = torch.empty(B, dtype=torch.int32, device=b2w.device)
    stream = torch.cuda.current_stream(b2w.device).cuda_stream
    launches += 1
    _build.check(lib.fx_packed_counts(
        b2w.data_ptr(), None if nmw is None else nmw.data_ptr(),
        lengths.data_ptr(), W16, B, worst.data_ptr(), ncnt.data_ptr(),
        stream), "fx_packed_counts")
    return worst, ncnt

"""K4: the adapter DP over ASCII bases, any adapter bytes.

Counterpart of ``fastx_toolkit_tpu/kernels/align_pallas.py::
align_batch_pallas`` (the unpacked kernel, entered from
``ops/clipper._align_dispatch``).  :func:`align_batch_unpacked` launches
the hand-written CUDA kernel ``csrc/align_unpacked.cu`` for CUDA tensors
and runs the plain torch DP (:func:`.align.align_batch`, which is its
plain version) for CPU tensors.  There is no fallback: a CUDA tensor
launches a kernel or raises.

Two routes, chosen by shape, each with its own launch counter:

* inside :func:`lanes_ok` (adapters of 1-127 bytes, ``L + H + H_pad <
  2^15``: every shape the CLIs give), the lane-group kernel
  (``fx_align_unpacked``, :data:`launches`): :func:`k4_pick` gives ``G``
  lanes a read and ``K`` adapter rows a lane in registers (one lane a
  read up to 21 rows), with a wavefront over the columns across the
  lanes.  The adapter goes by value, as a kernel parameter, so no copy
  precedes the launch: as byte classes against an alphabet of at most 6
  non-N bytes (:func:`adapter_table`, the table variant) or as the bytes
  themselves (the compare variant).  The kernel always computes the
  ``tie_fragile`` flags; without ``tie_flag`` they are left out;
* beyond it, the one-thread-per-read kernel (``fx_align_unpacked_serial``,
  :data:`serial_launches`) over transposed bases, with the row state in a
  device scratch ``[7, H, B]`` int32 allocated here and the adapter's
  device copy cached per (adapter, device).

Unlike the reference kernel there is no tile padding (any B, the ragged
edge is masked in the kernel) and no adapter bound below the plain
version's.
"""

from __future__ import annotations

import torch

from . import _build
from .align import FIELDS, align_batch
from .align_cuda import _h_pad

# kernel launches by align_batch_unpacked (reset them to 0 to count a
# run): the lane-group kernel and the one-thread-per-read route
launches = 0
serial_launches = 0

# the lane-group kernel's picks by variant, (rows, lanes G, rows a lane
# K): the first with rows >= H (``TABLE_PICKS`` and ``COMPARE_PICKS`` in
# csrc/align_unpacked.cu, which tests/test_torch_align_unpacked.py holds
# equal); its adapter bound
K4_TABLE_PICKS = ((17, 1, 17), (21, 1, 21), (34, 2, 17), (72, 4, 18),
                  (128, 8, 16))
K4_COMPARE_PICKS = ((8, 1, 8), (16, 2, 8), (32, 4, 8), (64, 8, 8),
                    (128, 16, 8))
K4_HMAX = 127
# the table variant's most distinct non-N adapter bytes
K4_ALPHA = 6

_adapter_dev = {}  # (adapter, device) -> its device copy (serial route)


def lanes_ok(L: int, H: int) -> bool:
    """The lane-group kernel's gate: a 7-bit target_start (H <= 127) and
    16-bit query_start and gaps fields (L + H + H_pad < 2^15)."""
    return 1 <= H <= K4_HMAX and L >= 0 and L + H + _h_pad(H) < (1 << 15)


def k4_pick(H: int, table: bool = True):
    """``(G, K)``: lanes a read and adapter rows a lane for an adapter of
    ``H`` bytes (1 <= H <= 127) in the table or the compare variant."""
    picks = K4_TABLE_PICKS if table else K4_COMPARE_PICKS
    return next((g, k) for rows, g, k in picks if H <= rows)


def adapter_table(adapter: bytes):
    """The table variant's operands ``(alphabet, classes)``: the distinct
    non-N bytes in order of first use, and each adapter byte's class (its
    rank in the alphabet, 6 for N); None for an adapter of more than 6
    distinct non-N bytes (the compare variant takes it)."""
    alpha = bytes(dict.fromkeys(c for c in adapter if c != ord("N")))
    if len(alpha) > K4_ALPHA:
        return None
    return alpha, bytes(6 if c == ord("N") else alpha.index(c)
                        for c in adapter)


def _device_adapter(adapter: bytes, dev):
    key = (adapter, dev)
    if key not in _adapter_dev:
        _adapter_dev[key] = torch.tensor(list(adapter),
                                         dtype=torch.uint8).to(dev)
    return _adapter_dev[key]


def _launch(bases, lengths, adapter: bytes, tie_flag: bool):
    global launches, serial_launches
    lib = _build.library()
    B, L = bases.shape
    H = len(adapter)
    dev = bases.device
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((9, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lanes_ok(L, H):
        bases = bases.contiguous()
        table = adapter_table(adapter)
        alpha, rows = table if table is not None else (b"", adapter)
        launches += 1
        _build.check(lib.fx_align_unpacked(
            bases.data_ptr(), lengths.data_ptr(), rows, alpha, len(alpha), H,
            L, B, 0 if table is None else 1, out.data_ptr(), stream),
            "fx_align_unpacked")
    else:
        basesT = bases.T.contiguous()                              # [L, B]
        ad = _device_adapter(adapter, dev)
        scratch = torch.empty((7, H, B), dtype=torch.int32, device=dev)
        serial_launches += 1
        _build.check(lib.fx_align_unpacked_serial(
            basesT.data_ptr(), lengths.data_ptr(), ad.data_ptr(), H, L, B,
            1 if tie_flag else 0, scratch.data_ptr(), out.data_ptr(), stream),
            "fx_align_unpacked_serial")
    res = dict(zip(FIELDS, out[:8]))
    if tie_flag:
        res["tie_fragile"] = out[8].bool()
    return res


def align_batch_unpacked(bases: torch.Tensor, lengths: torch.Tensor,
                         adapter: bytes, tie_flag: bool = False):
    """align_batch on ``bases`` (uint8 ``[B, L]``, ASCII, any bytes beyond
    ``lengths``) against ``adapter`` (any bytes).  Returns a dict of int32
    ``[B]`` tensors (:data:`.align.FIELDS`), plus ``tie_fragile`` bool
    ``[B]`` with ``tie_flag``."""
    if bases.dtype != torch.uint8 or bases.dim() != 2:
        raise ValueError("bases must be a [B, L] uint8 tensor")
    if tuple(lengths.shape) != (bases.shape[0],) or \
            lengths.device != bases.device:
        raise ValueError("lengths must be a [%d] tensor on %s"
                         % (bases.shape[0], bases.device))
    if len(adapter) < 1:
        raise ValueError("empty adapter")
    if bases.is_cuda:
        return _launch(bases, lengths, adapter, tie_flag)
    if bases.device.type == "cpu":
        return align_batch(bases, lengths, adapter, tie_flag=tie_flag)
    raise ValueError("unsupported device %s" % bases.device)

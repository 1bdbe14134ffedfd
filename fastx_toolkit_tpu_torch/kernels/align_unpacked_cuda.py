"""K4: the adapter DP over ASCII bases, any adapter bytes.

Counterpart of ``fastx_toolkit_tpu/kernels/align_pallas.py::
align_batch_pallas`` (the unpacked kernel, entered from
``ops/clipper._align_dispatch``).  :func:`align_batch_unpacked` launches
the hand-written CUDA kernel ``csrc/align_unpacked.cu`` for CUDA tensors
and runs the plain torch DP (:func:`.align.align_batch`, which is its
plain version) for CPU tensors.  There is no fallback: a CUDA tensor
launches the kernel or raises.

Unlike the reference kernel there is no tile padding (any B, the ragged
edge is masked in the kernel) and no adapter bound below the plain
version's: adapters whose row state does not fit shared memory keep it
in a device scratch ``[7, H, B]`` int32 allocated here.
"""

from __future__ import annotations

import torch

from . import _build
from .align import FIELDS, align_batch

# kernel launches by align_batch_unpacked (reset it to 0 to count a run)
launches = 0


def _launch(bases, lengths, adapter: bytes, tie_flag: bool):
    global launches
    lib = _build.library()
    B, L = bases.shape
    H = len(adapter)
    dev = bases.device
    basesT = bases.T.contiguous()                                  # [L, B]
    lengths = lengths.to(torch.int32).contiguous()
    ad = torch.tensor(list(adapter), dtype=torch.uint8).to(dev)
    scratch = None
    if not lib.fx_align_unpacked_smem_ok(H):
        scratch = torch.empty((7, H, B), dtype=torch.int32, device=dev)
    out = torch.empty((9, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches += 1
    _build.check(lib.fx_align_unpacked(
        basesT.data_ptr(), lengths.data_ptr(), ad.data_ptr(), H, L, B,
        1 if tie_flag else 0, None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), stream), "fx_align_unpacked")
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

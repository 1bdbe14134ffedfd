"""P on the card: the plane-op probe as a Hopper kernel.

:func:`plane_probe` launches ``csrc/plane_probe.cu`` when ``out`` lies on
a CUDA device and writes :func:`.probe.plane_probe_plain`'s values into it
when ``out`` lies on the CPU.  There is no fallback: a CUDA tensor
launches the kernel or raises.  Every variant computes the same values:

* ``residence``: ``"reg"`` (the plane in registers, one thread per
  column, as K1 keeps its row state) or ``"smem"`` (the plane in shared
  memory, ``[row][thread]``, 64 threads a block, as K3 and K4 keep theirs;
  ``smem_bytes`` may give a block more than the plane needs, to run at a
  DP kernel's occupancy);
* ``dpx``: the dependent cases' ``max(v, v - t)`` as one Hopper DPX
  instruction (``__viaddmax_s32`` / ``__viaddmax_s16x2``).

int16 planes run as packed pairs of neighbouring columns, so ``B`` is even
for them.
"""

from __future__ import annotations

import torch

from . import _build
from .probe import CASES, CHAINS, plane_probe_plain

# kernel launches by plane_probe (reset it to 0 to count a run)
launches = 0

H_SET = (17, 21, 24, 32, 33, 72)  # the rows the kernel is built for
SMEM_THREADS = 64
SMEM_MAX = 232_448  # dynamic shared memory a block may have on Hopper


def smem_need(case: str, H: int) -> int:
    """Shared-memory bytes a block's planes take in the ``smem``
    residence (8 planes for the independent chains)."""
    dep = CASES[case][0]
    return (1 if dep else CHAINS) * H * SMEM_THREADS * 4


def plane_probe(case: str, out, *, H: int, K: int, U: int,
                residence: str = "reg", dpx: bool = False,
                smem_bytes: int = 0):
    """Row 0 of the probe's ``[H, B]`` plane after ``K`` steps of ``U``
    plane ops, into ``out`` (``[B]``, the case's dtype); returns ``out``.
    ``smem_bytes`` (``smem`` only): shared memory a block, at least
    :func:`smem_need`; 0 means exactly that."""
    global launches
    dep, _h, dtype = CASES[case]
    if residence not in ("reg", "smem"):
        raise ValueError("residence must be 'reg' or 'smem'")
    if dpx and not dep:
        raise ValueError("dpx applies to the dependent cases only")
    if out.dtype != dtype or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("out must be a contiguous [B] %s tensor" % dtype)
    if H not in H_SET:
        raise ValueError("H must be one of %s" % (H_SET,))
    if K < 0 or U < 8:
        raise ValueError("K >= 0 and U >= 8")
    B = out.shape[0]
    if dtype == torch.int16 and B % 2:
        raise ValueError("int16 planes run as column pairs: B must be even")
    need = smem_need(case, H)
    smem_bytes = smem_bytes or need
    if residence == "smem" and not need <= smem_bytes <= SMEM_MAX:
        raise ValueError("smem_bytes must lie in [%d, %d]" % (need, SMEM_MAX))
    if out.device.type == "cpu":
        out.copy_(plane_probe_plain(case, H, B, K, U))
        return out
    if not out.is_cuda:
        raise ValueError("unsupported device %s" % out.device)
    lib = _build.probe_library()
    words = B // 2 if dtype == torch.int16 else B
    stream = torch.cuda.current_stream(out.device).cuda_stream
    launches += 1
    _build.check(lib.fx_plane_probe(
        int(residence == "smem"), int(dep), int(dtype == torch.int16),
        int(dpx), H, words, K, U, smem_bytes, out.data_ptr(), stream),
        "fx_plane_probe")
    return out

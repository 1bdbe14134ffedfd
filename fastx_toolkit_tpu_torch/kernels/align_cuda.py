"""K1 and K3: the adapter DP read straight from the 2-bit packed upload.

Counterpart of ``fastx_toolkit_tpu/kernels/align_pallas.py``
(``packed12_ok``, ``pallas_bounds_ok``, ``adapter_codes``,
``align_batch_pallas_packed``).  :func:`align_batch_packed` launches the
hand-written CUDA kernel ``csrc/align_packed.cu`` (``fx_align_packed``)
for CUDA tensors, at the shapes of both TPU kernels it replaces, each
counted on its own counter:

* K1's, inside :func:`packed12_ok` (adapters of 1-31 bases, reads of at
  most 511 columns; :data:`launches`);
* K3's, outside it and inside :func:`packed_wide_ok` (adapters of up to
  72 bases, reads up to the reference's packed-field bound;
  :data:`wide_launches`).

The kernel runs a lane group per read: :func:`k3_lanes` lanes, each
holding :data:`K3_ROWS` adapter rows in registers, with a wavefront over
the columns across the lanes (lane ``j`` computes column ``s - j`` at
step ``s`` and hands its last row and the column's partial max to lane
``j + 1``).

For CPU tensors it runs :func:`align_batch_packed_plain`, which unpacks
the words to ASCII (N wherever the N plane bit is set) and calls the
plain torch DP (:func:`.align.align_batch`).  There is no fallback: a
CUDA tensor launches the kernel or raises.

Operand layout (the engine's, ``engine/pipeline.py::_words_T``):
``b2w`` ``[ceil(L/32)*2, B]`` int32 — 16 two-bit codes per word (A0 C1 G2
T3, MSB-first within a byte, bytes little-endian); ``nmw``
``[ceil(L/32), B]`` int32 — the effective-N bit plane (input N OR masked
positions, MSB-first bytes), or None when the batch has no N source.
``L`` is the true column count; the words may cover more.
"""

from __future__ import annotations

import torch

from . import _build
from .align import FIELDS, align_batch

_CODE_OF = {65: 0, 67: 1, 71: 2, 84: 3, 78: 4}  # A C G T N
_ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)

# launches of csrc/align_packed.cu by align_batch_packed (reset them to 0
# to count a run): at K1's shapes (packed12_ok) and at K3's
launches = 0
wide_launches = 0


# K3's schedule: adapter rows a lane (``constexpr int K`` in
# csrc/align_packed.cu, which tests/test_torch_align_wide.py holds equal),
# and lanes a read, the least power of two that holds H rows (launch_g)
K3_ROWS = 9


def k3_lanes(H: int) -> int:
    """Lanes K3 gives a read for an adapter of ``H`` bases (1, 2, 4 or 8)."""
    g = 1
    while g * K3_ROWS < H:
        g *= 2
    return g


def _h_pad(H: int) -> int:
    return max(8, -(-H // 8) * 8)


def packed12_ok(L: int, H: int) -> bool:
    """K1's gate, the reference P12 kernel's: adapters of 1-31 bases and
    reads of at most 511 columns."""
    return 1 <= H <= 31 and L <= 511


def pallas_bounds_ok(L: int, H: int) -> bool:
    """The reference's packed path-statistic field bounds: counters fit 8
    bits (H <= 255) and the gap field fits 15 bits (L + H + H_pad <
    2^15)."""
    return H <= 255 and L + H + _h_pad(H) < (1 << 15)


def packed_wide_ok(L: int, H: int) -> bool:
    """K3's gate, the reference's two-plane packed kernel's: adapters
    with H_pad <= 72 (``packed_tile_for``) inside the field bounds."""
    return 1 <= H and _h_pad(H) <= 72 and pallas_bounds_ok(L, H)


def packed_ok(L: int, H: int) -> bool:
    """True iff K1 or K3 takes an ACGTN adapter of ``H`` bases against
    reads of ``L`` columns."""
    return packed12_ok(L, H) or packed_wide_ok(L, H)


def adapter_codes(adapter: bytes):
    """Adapter as codes (A0 C1 G2 T3 N4), or None for a letter the packed
    path cannot represent."""
    try:
        return [_CODE_OF[c] for c in adapter]
    except KeyError:
        return None


def unpack_codes(b2w: torch.Tensor, L: int) -> torch.Tensor:
    """``[W16, B]`` words -> ``[B, L]`` int32 two-bit codes."""
    xs = torch.arange(L, device=b2w.device)
    words = b2w[xs // 16]                                          # [L, B]
    shift = (8 * ((xs // 4) % 4) + 6 - 2 * (xs % 4)).to(torch.int32)
    return ((words >> shift[:, None]) & 3).T


def unpack_bits(nmw: torch.Tensor, L: int) -> torch.Tensor:
    """``[W32, B]`` N-plane words -> ``[B, L]`` bool."""
    xs = torch.arange(L, device=nmw.device)
    words = nmw[xs // 32]
    shift = (8 * ((xs // 8) % 4) + 7 - (xs % 8)).to(torch.int32)
    return (((words >> shift[:, None]) & 1) == 1).T


def check_operands(b2w, nmw, lengths, L: int = 0):
    """Raise ValueError unless the operands have the packed kernels'
    layout: ``b2w`` ``[W16, B]`` int32 covering ``L`` columns in whole
    32-column words, ``nmw`` ``[W16/2, B]`` int32 or None, ``lengths``
    ``[B]`` int32, all contiguous on one device."""
    if b2w.dtype != torch.int32 or b2w.dim() != 2 or not b2w.is_contiguous():
        raise ValueError("b2w must be a contiguous [words, B] int32 tensor")
    W16, B = b2w.shape
    if W16 % 2 or W16 * 16 < L:
        raise ValueError("b2w rows %d do not cover L=%d in whole 32-column "
                         "words" % (W16, L))
    if nmw is not None and (nmw.dtype != torch.int32
                            or tuple(nmw.shape) != (W16 // 2, B)
                            or not nmw.is_contiguous()
                            or nmw.device != b2w.device):
        raise ValueError("nmw must be a contiguous [%d, %d] int32 tensor on "
                         "%s" % (W16 // 2, B, b2w.device))
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,)
            or not lengths.is_contiguous() or lengths.device != b2w.device):
        raise ValueError("lengths must be a contiguous [%d] int32 tensor on "
                         "%s" % (B, b2w.device))


def align_batch_packed_plain(b2w, nmw, lengths, adapter: bytes, L: int,
                             tie_flag: bool = False):
    """The plain torch version of K1 and K3 on any device: unpack to
    ASCII, then :func:`.align.align_batch`."""
    bases = _ASCII.to(b2w.device)[unpack_codes(b2w, L).long()]
    if nmw is not None:
        bases = torch.where(unpack_bits(nmw, L), torch.tensor(
            ord("N"), dtype=torch.uint8, device=b2w.device), bases)
    return align_batch(bases, lengths, adapter, tie_flag=tie_flag)


def _launch(b2w, nmw, lengths, codes, L: int, tie_flag: bool):
    global launches, wide_launches
    lib = _build.library()
    B = b2w.shape[1]
    out = torch.empty((9, B), dtype=torch.int32, device=b2w.device)
    stream = torch.cuda.current_stream(b2w.device).cuda_stream
    if packed12_ok(L, len(codes)):
        launches += 1
    else:
        wide_launches += 1
    _build.check(lib.fx_align_packed(
        b2w.data_ptr(), None if nmw is None else nmw.data_ptr(),
        lengths.data_ptr(), bytes(codes), len(codes), L, B,
        1 if tie_flag else 0, out.data_ptr(), stream), "fx_align_packed")
    res = dict(zip(FIELDS, out[:8]))
    if tie_flag:
        res["tie_fragile"] = out[8].bool()
    return res


def align_batch_packed(b2w, nmw, lengths, adapter: bytes, L: int,
                       tie_flag: bool = False):
    """align_batch on the packed operands (see the module docstring).
    Returns a dict of int32 ``[B]`` tensors, plus ``tie_fragile`` bool
    ``[B]`` with ``tie_flag``.

    With no N plane and an ACGT adapter no neutral can occur, every score
    is exact in float32 and the flags are provably zero: the flag-free
    kernel runs and the flags are synthesized, like the reference wrapper
    (``align_pallas.py:908-918``)."""
    codes = adapter_codes(adapter)
    if codes is None:
        raise ValueError("adapter outside ACGTN: the packed DP cannot "
                         "represent it (the unpacked DP, K4, takes it)")
    if not packed_ok(L, len(adapter)):
        raise ValueError("packed DP bounds exceeded (L=%d, adapter=%d): "
                         "the unpacked DP, K4, takes it" % (L, len(adapter)))
    check_operands(b2w, nmw, lengths, L)
    zero_flags = tie_flag and nmw is None and all(c < 4 for c in codes)
    run_flags = tie_flag and not zero_flags
    if b2w.is_cuda:
        res = _launch(b2w, nmw, lengths, codes, L, run_flags)
    elif b2w.device.type == "cpu":
        res = align_batch_packed_plain(b2w, nmw, lengths, adapter, L,
                                       tie_flag=run_flags)
    else:
        raise ValueError("unsupported device %s" % b2w.device)
    if zero_flags:
        res["tie_fragile"] = torch.zeros(b2w.shape[1], dtype=torch.bool,
                                         device=b2w.device)
    return res

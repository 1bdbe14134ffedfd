"""K5: the quality-stats histogram, on ASCII bases or on 2-bit codes.

Counterpart of ``fastx_toolkit_tpu/kernels/stats_pallas.py``
(``stats_hist_pallas`` and ``stats_hist_pallas_b2``): per position, the
count of weight-1 bases in each (nucleotide slot, quality bin) pair ->
int32 ``[L, 6, 109]``.  The slot is ``STATS_INDEX[byte]`` (0 for bytes
outside ``AaCcGgTtNn``) or, for the 2-bit ``pack_batch2`` bytes (4 codes
a byte, MSB first), ``code + 1``; the bin is ``clip(q + 15, 0, 108)``;
positions at or past a read's length are not counted.

:func:`stats_hist` / :func:`stats_hist_b2` launch ``csrc/stats_hist.cu``
for CUDA tensors and run :func:`stats_hist_plain` /
:func:`stats_hist_b2_plain` (flat bin ids and one ``torch.bincount``) for
CPU tensors.  There is no fallback: a CUDA tensor launches the kernel or
raises.  Any B and any L (no tile padding).

The library takes a batch on one of two routes, each counted on its own
counter: the one-tile kernel for ``L <= K5_LMAX`` and rows of at most
``K5_LMAX`` bytes (:func:`tile_ok`; :data:`launches`,
:data:`b2_launches`), whose schedule :func:`k5_plan` mirrors, and the
tiled kernel for any other shape (:data:`tiled_launches`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.records import BaseCode
from ..ops.stats import MIN_Q, NBINS, NSLOTS
from . import _build

F = NSLOTS * NBINS  # 654 bins per position

# kernel launches (reset to 0 to count a run): the one-tile kernel by
# stats_hist and by stats_hist_b2, and the tiled kernel by either
launches = 0
b2_launches = 0
tiled_launches = 0

# the one-tile kernel's constants (constexprs of csrc/stats_hist.cu, held
# equal by tests/test_torch_stats.py): the widest L and 2-bit row it takes,
# the most reads a block tallies into its 16-bit counters, its tally warps,
# ring stages, the most reads a stage, the fewest reads worth a block, the
# blocks of a cluster, and the shared memory of its slot table
K5_LMAX = 160
K5_CAP = 65535
K5_WARPS = 31
K5_STAGES = 2
K5_RMAX = 256
K5_MIN_PER = 64
K5_CLUSTER = 4
K5_LUT_BYTES = 512
FW = F // 2  # 16-bit bin pairs a position


def tile_ok(L: int, W: int) -> bool:
    """True when the one-tile kernel takes a batch of ``L`` positions and
    rows of ``W`` code bytes."""
    return L <= K5_LMAX and W <= K5_LMAX


def _align16(x: int) -> int:
    return (x + 15) & ~15


def k5_plan(B: int, L: int, W: int, active: int, optin: int):
    """The one-tile kernel's schedule (``make_plan`` in the .cu) for ``B``
    reads with ``active`` clusters resident and ``optin`` bytes of shared
    memory a block: ``(blocks, per, R, P, smem)`` — blocks (a multiple of
    the cluster), reads a block, reads a stage, the tile's position stride
    and a block's shared memory; None if a stage cannot hold one read."""
    P = -(-L // 32) * 32
    tile = FW * P * 4 + K5_LUT_BYTES + 16 * K5_STAGES  # and the barriers

    def stage(r):
        return (_align16(r * W + 31) + _align16(r * L + 31)
                + _align16(4 * r + 31))

    R = K5_RMAX
    while R > 0 and K5_STAGES * stage(R) > optin - tile:
        R -= 1
    if R < 1:
        return None
    if R >= K5_WARPS:
        R -= R % K5_WARPS
    blocks = max(1, min(active * K5_CLUSTER, -(-B // K5_MIN_PER)))
    per = max(1, min(K5_CAP, -(-B // blocks)))
    blocks = -(-B // per)
    blocks = -(-blocks // K5_CLUSTER) * K5_CLUSTER
    R = min(R, per)
    return blocks, per, R, P, tile + K5_STAGES * stage(R)


def library_plan(B: int, L: int, W: int, b2: bool):
    """The library's plan for a launch on the current CUDA device
    (``fx_stats_hist_plan``): ``{"tile", "active", "blocks", "per", "R",
    "P", "smem", "optin"}``; ``tile`` is False on the tiled route."""
    plan = (ctypes.c_int * 8)()
    _build.check(_build.library().fx_stats_hist_plan(B, L, W, int(b2), plan),
                 "fx_stats_hist_plan")
    return dict(zip(("tile", "active", "blocks", "per", "R", "P", "smem",
                     "optin"), [bool(plan[0])] + list(plan[1:])))


def _check(codes, quals, lengths, what: str):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("%s must be a [B, W] uint8 tensor" % what)
    if quals.dtype != torch.int8 or quals.dim() != 2 or \
            quals.shape[0] != codes.shape[0]:
        raise ValueError("quals must be a [%d, L] int8 tensor" % codes.shape[0])
    if tuple(lengths.shape) != (codes.shape[0],):
        raise ValueError("lengths must be a [%d] tensor" % codes.shape[0])
    if len({codes.device, quals.device, lengths.device}) != 1:
        raise ValueError("operands on different devices")


def ascii_slots(bases):
    """ASCII bases ``[B, L]`` -> nucleotide slots int64 (``STATS_INDEX``)."""
    lut = torch.from_numpy(BaseCode.STATS_INDEX).to(bases.device)
    return lut[bases.long()].to(torch.int64)


def b2_slots(b2, L: int):
    """``pack_batch2`` bytes ``[B, W4]`` -> slots ``code + 1`` int64
    ``[B, L]``."""
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.int64, device=b2.device)
    codes = (b2.to(torch.int64)[:, :, None] >> shifts) & 3
    return codes.reshape(b2.shape[0], -1)[:, :L] + 1


def flat_ids(slot, quals, lengths):
    """The flat bin ids ``x * 654 + slot * 109 + qbin`` of the counted
    bases (positions ``x < lengths``), int64 in row order."""
    B, L = quals.shape
    col = torch.arange(L, device=quals.device)
    valid = col[None, :] < lengths.to(torch.int64)[:, None]
    qbin = (quals.to(torch.int64) - MIN_Q).clamp(0, NBINS - 1)
    return (col[None, :] * F + slot * NBINS + qbin)[valid]


def hist_from_flat(flat, L: int):
    """One ``torch.bincount`` of flat ids -> int32 ``[L, 6, 109]``."""
    return torch.bincount(flat, minlength=L * F).to(torch.int32).reshape(
        L, NSLOTS, NBINS)


def stats_hist_plain(bases, quals, lengths):
    """The plain torch version of K5 on ASCII bases, on any device."""
    return hist_from_flat(flat_ids(ascii_slots(bases), quals, lengths),
                          quals.shape[1])


def stats_hist_b2_plain(b2, quals, lengths):
    """The plain torch version of K5 on 2-bit codes, on any device."""
    L = quals.shape[1]
    return hist_from_flat(flat_ids(b2_slots(b2, L), quals, lengths), L)


def _launch(b2_mode: bool, codes, quals, lengths):
    global launches, b2_launches, tiled_launches
    B, L = quals.shape
    out = torch.zeros((L, NSLOTS, NBINS), dtype=torch.int32,
                      device=codes.device)
    if B == 0 or L == 0:
        return out
    lib = _build.library()
    codes = codes.contiguous()
    quals = quals.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    if not tile_ok(L, codes.shape[1]):
        tiled_launches += 1
    elif b2_mode:
        b2_launches += 1
    else:
        launches += 1
    _build.check(lib.fx_stats_hist(
        codes.data_ptr(), quals.data_ptr(), lengths.data_ptr(), B, L,
        codes.shape[1], 1 if b2_mode else 0, sms, out.data_ptr(), stream),
        "fx_stats_hist")
    return out


def stats_hist(bases, quals, lengths):
    """Histogram int32 ``[L, 6, 109]`` of ``bases`` (uint8 ``[B, L]``,
    ASCII), ``quals`` (int8 ``[B, L]``) and ``lengths`` (``[B]``)."""
    _check(bases, quals, lengths, "bases")
    if bases.shape != quals.shape:
        raise ValueError("bases and quals differ in shape")
    if bases.is_cuda:
        return _launch(False, bases, quals, lengths)
    if bases.device.type == "cpu":
        return stats_hist_plain(bases, quals, lengths)
    raise ValueError("unsupported device %s" % bases.device)


def stats_hist_b2(b2, quals, lengths):
    """:func:`stats_hist` on pure-ACGT reads given as ``pack_batch2`` bytes
    ``b2`` (uint8 ``[B, >= ceil(L/4)]``) with ``quals`` int8 ``[B, L]``."""
    _check(b2, quals, lengths, "b2")
    if b2.shape[1] * 4 < quals.shape[1]:
        raise ValueError("b2 holds %d codes a row, quals %d"
                         % (b2.shape[1] * 4, quals.shape[1]))
    if b2.is_cuda:
        return _launch(True, b2, quals, lengths)
    if b2.device.type == "cpu":
        return stats_hist_b2_plain(b2, quals, lengths)
    raise ValueError("unsupported device %s" % b2.device)

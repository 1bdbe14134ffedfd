"""P, the plane-op probe: its four cases and its plain torch version.

Counterpart of the Pallas kernel in ``bench.py::vpu_probe`` (its
``pl.pallas_call`` at ``bench.py:1274``): an ``[H, B]`` plane starts at
ones; each of ``K`` steps, with ``t = step + 1``, runs ``U`` plane ops on
it, the dependent chain (``+ t``, ``^ (k + 1)``, ``max(v, v - t)``,
``v + (v >> bits - 1)``) or 8 independent chains of ``+ t`` / ``^ (k + 1)``
summed at the end, in wrapping int32 or int16 arithmetic; the output is
row 0 of the plane after the last step.  The TPU ran it on ``[24, 2048]``
int32 and ``[32, 2048]`` int16 planes with ``K = 32`` and ``U = 256``.
The Hopper kernel is ``kernels/probe_cuda.py``; the entry point that times
it is ``fastx_toolkit_tpu_torch/probe.py``.
"""

from __future__ import annotations

import torch

# name -> (dependent chain?, the TPU's rows H, dtype)
CASES = {
    "dependent": (True, 24, torch.int32),
    "independent": (False, 24, torch.int32),
    "dependent_i16": (True, 32, torch.int16),
    "independent_i16": (False, 32, torch.int16),
}
TPU_B, TPU_K, TPU_U = 2048, 32, 256
CHAINS = 8


def plane_probe_plain(case: str, H: int, B: int, K: int, U: int,
                      device=None):
    """Row 0 (``[B]``, the case's dtype) of the probe's plane after ``K``
    steps of ``U`` plane ops, computed op by op on whole planes as the
    Pallas body does, on ``device`` (default the CPU)."""
    dep, _h, dtype = CASES[case]
    shift = torch.iinfo(dtype).bits - 1
    v = torch.ones((H, B), dtype=dtype, device=device)
    for step in range(K):
        t = step + 1
        if dep:
            for k in range(U // 4):
                v = v + t
                v = v ^ (k + 1)
                v = torch.maximum(v, v - t)
                v = v + (v >> shift)
        else:
            acc = [v + j for j in range(CHAINS)]
            for k in range(U // 8 - 1):
                acc = [a + t if k % 2 else a ^ (k + 1) for a in acc]
            v = acc[0]
            for a in acc[1:]:
                v = v + a
    return v[0].clone()


def plane_ops(K: int, U: int) -> int:
    """Plane ops per element, counted as the TPU probe counts them
    (``K x U``; approximate for the independent chains)."""
    return K * U

"""P on the card: the plane-op probe's rates on one GPU.

Counterpart of ``bench.py --vpuprobe``.  Run from the repository root:

    python -m fastx_toolkit_tpu_torch.probe

On a CUDA device (``FASTX_TORCH_DEVICE``, default ``cuda``) it runs every
variant of the probe kernel (``csrc/plane_probe.cu``: the four TPU cases,
plus DPX for the two dependent ones) in both residences (``reg``,
``smem``), first at the DP kernels' shapes (B = 262,144 columns, H = 17,
21, 33 and 72 rows: the headline, small-RNA and TruSeq adapters and K3's
widest; ``smem`` with 3 x H x 256 bytes a block, the row state of K3's
earlier one-thread-per-read design, where the plane needs less) and then at the TPU's own shape (``[24, 2048]`` int32, ``[32,
2048]`` int16), with the TPU's K = 32 steps of U = 256 plane ops.  Each
run is timed with CUDA events over 10 launches after a warm-up, and
prints one JSON line:
``metric`` (``plane_probe_<residence>_<variant>``), ``ops_per_s`` (plane
ops x elements / second, the ops counted as the TPU probe counts them:
K x U an element), ``bytes_per_s`` (``smem`` only: a read and a write of
each element each op), ``share_of_assumed_int32`` (of 132 SMs x 64 lanes
x 1.98 GHz = 16.7 T op/s), the SASS instructions per plane op in the
kernel's hot loop where ``cuobjdump`` can show them (with the shared
loads and stores per op, which show that the ``smem`` plane is not kept
in registers), and the card's name and power limit.

On the CPU (``FASTX_TORCH_DEVICE=cpu``) it computes the plain version's
values at the TPU's shape, K and U and prints them, with no rate.  A
missing CUDA device is an error, never a CPU run.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

from .device import resolve_device
from .kernels import _build, probe_cuda
from .kernels.probe import CASES, TPU_B, TPU_K, TPU_U, plane_ops

ASSUMED_INT32_OPS = 132 * 64 * 1.98e9  # SMs x INT32 lanes x max SM clock
DP_B = 262_144
DP_H = (17, 21, 33, 72)
# the row state K3's earlier one-thread-per-read design kept in shared
# memory: score, W1, W2 per row and thread
K3_SMEM_WORDS_A_ROW = 3
VARIANTS = (("dependent", False), ("dependent", True), ("independent", False),
            ("dependent_i16", False), ("dependent_i16", True),
            ("independent_i16", False))
RESIDENCES = ("reg", "smem")
GROUP = 8  # rows the reg independent kernel keeps in flight (plane_probe.cu)
REPS = 10  # timed launches a run


def variant_name(case: str, dpx: bool) -> str:
    return case + ("_dpx" if dpx else "")


def runs():
    """Every (residence, case, dpx, H, B, smem_bytes) the probe times: the
    DP shapes first, then the TPU's."""
    out = []
    for H in DP_H:
        for res in RESIDENCES:
            for case, dpx in VARIANTS:
                smem = 0
                if res == "smem":
                    smem = max(probe_cuda.smem_need(case, H),
                               K3_SMEM_WORDS_A_ROW * H * 64 * 4)
                out.append((res, case, dpx, H, DP_B, smem))
    for res in RESIDENCES:
        for case, dpx in VARIANTS:
            H = CASES[case][1]
            smem = probe_cuda.smem_need(case, H) if res == "smem" else 0
            out.append((res, case, dpx, H, TPU_B, smem))
    return out


def card() -> str:
    """``name, power.limit`` as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --- SASS: instructions per plane op in each kernel's hot loop ----------

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_KERNEL = re.compile(r"probe_(reg|smem)ILi(\d+)ELb([01])ELb([01])ELb([01])E")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*)[^;]*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _hot_loop(lines, need=None):
    """Opcode counts of the largest innermost loop in one function's SASS
    (the span from a backward branch's target to the branch), among those
    that hold an instruction ``need`` when it is given."""
    instrs, labels, branches = [], {}, []
    pending = []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        instrs.append((addr, m.group(2)))
        if m.group(2) == "BRA":
            t = _TARGET.search(line)
            if t:
                branches.append((addr, t.group(1) or int(t.group(2), 16)))
    loops = []
    for addr, tgt in branches:
        tgt = labels.get(tgt) if isinstance(tgt, str) else tgt
        if tgt is not None and tgt < addr:  # not the trap's self-branch
            loops.append((tgt, addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in loops)]
    if need is not None:
        inner = [(a, b) for a, b in inner
                 if any(a <= addr <= b and op == need for addr, op in instrs)]
    if not inner:
        return None
    best = max(inner, key=lambda s: s[1] - s[0])
    hist = {}
    for addr, op in instrs:
        if best[0] <= addr <= best[1] and op != "NOP":
            hist[op] = hist.get(op, 0) + 1
    return hist


def _loop_plane_ops(res: str, dep: bool, H: int) -> int:
    """Plane ops per element-word in one pass of the hot loop, as the
    kernel source writes it: one k of the dependent chain (4 ops a row),
    or one (xor, add) pair of the 8 independent chains (over a group of
    GROUP rows in ``reg``, over all H rows in ``smem``)."""
    if dep:
        return 4 * H
    return 2 * 8 * (min(GROUP, H) if res == "reg" else H)


def sass_functions(obj: str) -> dict:
    """``{mangled name: SASS lines}`` of every function in the object file
    ``obj`` (``cuobjdump --dump-sass``); empty when cuobjdump or the object
    is missing."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not (os.path.exists(obj) and os.access(tool, os.X_OK)):
        return {}
    text = subprocess.run([tool, "--dump-sass", obj], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, body = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            body = funcs.setdefault(m.group(1), [])
        elif body is not None:
            body.append(line)
    return funcs


def sass_report():
    """``{(res, H, dep, i16, dpx): {"instr_per_op", "lds_per_op",
    "sts_per_op", "ops"}}`` from ``cuobjdump --dump-sass`` of the built
    probe object; empty when cuobjdump or the object is missing."""
    obj = os.path.join(_build.BUILD_DIR,
                       _build.build_key(_build.PROBE_SOURCES),
                       "plane_probe.cu.o")
    report = {}
    for name, body in sass_functions(obj).items():
        m = _KERNEL.search(name)
        hist = _hot_loop(body) if m else None
        if not hist:
            continue
        res, H = m.group(1), int(m.group(2))
        dep, i16, dpx = (m.group(k) == "1" for k in (3, 4, 5))
        ops = _loop_plane_ops(res, dep, H)
        report[(res, H, dep, i16, dpx)] = {
            "instr_per_op": sum(hist.values()) / ops,
            "lds_per_op": hist.get("LDS", 0) / ops,
            "sts_per_op": hist.get("STS", 0) / ops,
            "ops": hist}
    return report


# --- the runs --------------------------------------------------------------

def measure(dev, budget_s: float | None = None, card_name: str = "",
            emit=print):
    """Time every run of :func:`runs` on the CUDA device ``dev`` at the
    TPU's K and U; emits and returns ``(one dict per run, sass_report())``
    (see the module docstring).  Each dict also holds, under ``out``, the
    row the last timed launch wrote, for a check against the plain
    version; it is not emitted.  With ``budget_s``, runs stop once that
    many seconds have passed, and a last line says how many were not
    made."""
    K, U = TPU_K, TPU_U
    sass = sass_report()
    results = []
    todo = runs()
    t_start = time.perf_counter()
    for n_done, (res, case, dpx, H, B, smem) in enumerate(todo):
        if budget_s is not None and time.perf_counter() - t_start > budget_s:
            emit(json.dumps({"metric": "plane_probe_budget",
                             "budget_s": budget_s,
                             "runs_made": n_done,
                             "runs_not_made": len(todo) - n_done}))
            break
        dep, _h, dtype = CASES[case]
        out = torch.empty(B, dtype=dtype, device=dev)
        ms = cuda_ms(lambda: probe_cuda.plane_probe(
            case, out, H=H, K=K, U=U, residence=res, dpx=dpx,
            smem_bytes=smem), REPS)
        esize = torch.iinfo(dtype).bits // 8
        work = plane_ops(K, U) * H * B
        r = {"metric": "plane_probe_%s_%s" % (res, variant_name(case, dpx)),
             "residence": res, "case": case, "dpx": dpx,
             "dtype": str(dtype).replace("torch.", ""),
             "plane_shape": [H, B], "K": K, "U": U,
             "smem_bytes_a_block": smem if res == "smem" else None,
             "ms": ms, "timed_launches": REPS,
             "ops_per_s": work / (ms * 1e-3),
             "bytes_per_s": (work * esize * 2 / (ms * 1e-3)
                             if res == "smem" else None),
             "share_of_assumed_int32": work / (ms * 1e-3) / ASSUMED_INT32_OPS}
        s = sass.get((res, H, dep, dtype == torch.int16, dpx))
        r["sass_instr_per_op"] = s["instr_per_op"] if s else None
        if res == "smem":
            r["sass_lds_per_op"] = s["lds_per_op"] if s else None
            r["sass_sts_per_op"] = s["sts_per_op"] if s else None
        r["card"] = card_name
        emit(json.dumps(r))
        r["out"] = out
        results.append(r)
    return results, sass


def main() -> int:
    dev = resolve_device()
    if dev.type == "cpu":
        for case, (_dep, H, dtype) in CASES.items():
            out = probe_cuda.plane_probe(
                case, torch.empty(TPU_B, dtype=dtype), H=H, K=TPU_K, U=TPU_U)
            print(json.dumps({
                "metric": "plane_probe_plain_%s" % case, "device": "cpu",
                "plane_shape": [H, TPU_B], "K": TPU_K, "U": TPU_U,
                "dtype": str(dtype).replace("torch.", ""),
                "row0_values": sorted(set(out.tolist()))}))
        return 0
    name = card()
    print("card: %s (%s)" % (name, torch.cuda.get_device_name(dev)),
          flush=True)
    _build.probe_library()
    measure(dev, card_name=name, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

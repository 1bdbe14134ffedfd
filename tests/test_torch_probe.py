"""P, the plane-op probe (``bench.py::vpu_probe``), in the port: its plain
torch version against the TPU kernel's body run by JAX on the CPU, its
entry point on the CPU (values, no rate), its wrapper's checks, and the
SASS reading that its entry point does on the card.

``make`` is a closure inside ``bench.vpu_probe`` and ``bench.py`` is not
changed, so :func:`_pallas_probe` rebuilds the same kernel body from
``bench.py:1246-1272`` here, verbatim apart from the sizes it takes, and
runs it through ``pl.pallas_call(..., interpret=True)`` (interpret mode
takes the ``pltpu.VMEM`` scratch plane) on the CPU.  Results are integers:
every comparison is exact (tolerance 0)."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastx_toolkit_tpu_torch import probe
from fastx_toolkit_tpu_torch.kernels import _build, probe_cuda
from fastx_toolkit_tpu_torch.kernels.probe import (
    CASES,
    TPU_B,
    TPU_K,
    TPU_U,
    plane_probe_plain,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JNP_DTYPE = {torch.int32: jnp.int32, torch.int16: jnp.int16}


def _pallas_probe(dep, H, dtype, Bt, K, U):
    """bench.py:1243-1281's ``make(dep, H, dtype)`` at ``Bt`` columns,
    ``K`` steps and ``U`` ops a step, in interpret mode."""
    nbits = jnp.iinfo(dtype).bits

    def kernel(o_ref, scr):
        @pl.when(pl.program_id(0) == 0)
        def _i():
            scr[:] = jnp.ones((H, Bt), dtype)

        # program_id-dependent operand defeats constant folding; mix
        # add/xor/max like the DP's op mix
        t = pl.program_id(0).astype(dtype) + 1
        v = scr[:]
        if dep:
            for k in range(U // 4):
                v = v + t
                v = v ^ dtype(k + 1)
                v = jnp.maximum(v, v - t)
                v = v + (v >> (nbits - 1))
        else:
            acc = [v + dtype(k) for k in range(8)]  # 8 indep chains
            for k in range(U // 8 - 1):
                acc = [a + t if k % 2 else a ^ dtype(k + 1) for a in acc]
            v = acc[0]
            for a in acc[1:]:
                v = v + a
        scr[:] = v

        @pl.when(pl.program_id(0) == pl.num_programs(0) - 1)
        def _f():
            o_ref[:] = v[0, :]

    return pl.pallas_call(
        kernel,
        grid=(K,),
        out_specs=pl.BlockSpec((Bt,), lambda i: (0,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Bt,), dtype),
        scratch_shapes=[pltpu.VMEM((H, Bt), dtype)],
        interpret=True,
    )


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("H,B,K,U", [
    (None, 256, 3, 16),    # the small size
    (None, 256, 32, 256),  # the TPU's K and U: the int16 chains wrap
    (17, 128, 3, 16),      # the headline adapter's rows
])
def test_plain_equals_the_pallas_body(case, H, B, K, U):
    dep, h_tpu, dtype = CASES[case]
    H = H or h_tpu
    want = np.asarray(_pallas_probe(dep, H, JNP_DTYPE[dtype], B, K, U)())
    got = plane_probe_plain(case, H, B, K, U)
    assert got.dtype == dtype and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    before = probe_cuda.launches
    for case, (dep, H, dtype) in CASES.items():
        for res in probe.RESIDENCES:
            for dpx in ((False, True) if dep else (False,)):
                out = torch.empty(64, dtype=dtype)
                got = probe_cuda.plane_probe(case, out, H=H, K=2, U=16,
                                             residence=res, dpx=dpx)
                assert got is out
                assert torch.equal(got, plane_probe_plain(case, H, 64, 2, 16))
    assert probe_cuda.launches == before


@pytest.mark.parametrize("kw,match", [
    ({"case": "independent", "dpx": True}, "dependent cases only"),
    ({"residence": "tmem"}, "residence"),
    ({"H": 20}, "H must be one of"),
    ({"U": 4}, "U >= 8"),
    ({"case": "dependent_i16", "B": 63}, "B must be even"),
    ({"dtype": torch.int64}, "contiguous"),
    ({"residence": "smem", "smem_bytes": 1024}, "smem_bytes"),
    ({"residence": "smem", "smem_bytes": 300_000}, "smem_bytes"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(kw, match):
    case = kw.pop("case", "dependent")
    B = kw.pop("B", 64)
    dtype = kw.pop("dtype", CASES[case][2])
    args = {"H": 24, "K": 1, "U": 16, **kw}
    with pytest.raises(ValueError, match=match):
        probe_cuda.plane_probe(case, torch.empty(B, dtype=dtype), **args)


def test_smem_need_and_the_dp_shapes():
    assert probe_cuda.smem_need("dependent", 72) == 18_432
    assert probe_cuda.smem_need("independent", 72) == 147_456
    runs = probe.runs()
    assert len(runs) == len(set(runs)) == 60
    # the smem runs at H = 72 take K3's 55,296 B a block where the plane
    # needs less, and every H the kernel is built for
    assert ("smem", "dependent", False, 72, 262_144, 55_296) in runs
    assert {r[3] for r in runs} <= set(probe_cuda.H_SET)


def test_probe_builds_into_its_own_library():
    """No CLI path runs the probe, so its many instantiations are built
    apart from the paths' kernels, under a key of their own."""
    csrc = os.path.join(ROOT, "fastx_toolkit_tpu_torch", "csrc")
    cu = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sorted(_build.SOURCES + _build.PROBE_SOURCES) == cu
    assert _build.PROBE_SOURCES == ("plane_probe.cu",)
    assert _build.build_key() == _build.build_key(_build.SOURCES)
    assert _build.build_key(_build.PROBE_SOURCES) != _build.build_key()
    assert _build.PROBE_LIB_NAME != _build.LIB_NAME


def test_smoke_checks_every_shape_the_probe_times():
    """chip_smoke.py holds the kernel against the plain version at each
    run path (p) times (same H, B and shared memory a block) and at the
    TPU's H with B = 262,144, every variant in both residences."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    shapes = chip_smoke.probe_shapes()
    assert len(shapes) == len(set(shapes)) == 72
    assert set(probe.runs()) <= set(shapes)
    for case, (dep, H, _dtype) in CASES.items():
        for res in probe.RESIDENCES:
            for dpx in ((False, True) if dep else (False,)):
                assert sum(s[:5] == (res, case, dpx, H, probe.DP_B)
                           for s in shapes) == 1
    assert chip_smoke.PROBE_TIMED + (0,) in shapes


def test_entry_point_on_cpu_prints_values_and_no_rate(monkeypatch):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert probe.main() == 0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [x["metric"] for x in lines] == [
        "plane_probe_plain_" + c for c in CASES]
    for x in lines:
        assert not {"ms", "ops_per_s", "bytes_per_s"} & set(x)
        H = x["plane_shape"][0]
        assert x["plane_shape"] == [H, TPU_B]
        assert (x["K"], x["U"]) == (TPU_K, TPU_U) == (32, 256)
        want = plane_probe_plain(x["metric"][len("plane_probe_plain_"):],
                                 H, TPU_B, TPU_K, TPU_U)
        assert x["row0_values"] == sorted(set(want.tolist()))


def test_entry_point_runs_without_jax_and_refuses_a_missing_card():
    code = ("import sys, runpy\n"
            "for m in ('jax', 'fastx_toolkit_tpu', 'bench'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv[1:] = []\n"
            "runpy.run_module('fastx_toolkit_tpu_torch.probe',"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert len(r.stdout.splitlines()) == 4
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the absent-card error "
                    "cannot be shown here")
    env["FASTX_TORCH_DEVICE"] = "cuda"
    r = subprocess.run([sys.executable, "-m", "fastx_toolkit_tpu_torch.probe"],
                       capture_output=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout == b""
    assert b"CUDA is not available" in r.stderr


SASS = """\
\t\tFunction : _ZN47_GLOBAL__N__x_14_plane_probe_cu_y9probe_regILi2ELb1ELb0ELb0EEEviiiiPj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/               @P0 EXIT ;
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0030*/                   VIADD R3, R3, UR4 ;
        /*0040*/                   LOP3.LUT R3, R3, UR5, RZ, 0x3c, !PT ;
        /*0050*/                   VIADDMNMX R3, R3, -UR4, R3, !PT ;
        /*0060*/                   LEA.HI R3, R3, R3, RZ, 0x1 ;
        /*0070*/                   VIADD R4, R4, UR4 ;
        /*0080*/                   LOP3.LUT R4, R4, UR5, RZ, 0x3c, !PT ;
        /*0090*/                   VIADDMNMX R4, R4, -UR4, R4, !PT ;
        /*00a0*/                   LEA.HI R4, R4, R4, RZ, 0x1 ;
        /*00b0*/                   ISETP.GE.AND P0, PT, R2, R5, PT ;
        /*00c0*/              @!P0 BRA 0x30 ;
        /*00d0*/                   ISETP.GE.AND P1, PT, R6, R7, PT ;
        /*00e0*/              @!P1 BRA 0x20 ;
        /*00f0*/                   EXIT ;
.L_x_1:
        /*0100*/                   BRA `(.L_x_1);
"""


def test_sass_reading_takes_the_innermost_loop():
    body = SASS.splitlines()[1:]
    hist = probe._hot_loop(body)
    assert hist == {"VIADD": 2, "LOP3": 2, "VIADDMNMX": 2, "LEA": 2,
                    "ISETP": 1, "BRA": 1}
    m = probe._KERNEL.search(SASS.splitlines()[0])
    assert m.groups() == ("reg", "2", "1", "0", "0")
    # one k of the dependent chain over H = 2 rows: 8 plane ops, 10
    # instructions
    assert probe._loop_plane_ops("reg", True, 2) == 8


def _k3_body():
    """A SASS loop of 6 instructions."""
    lines = ["        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
    ops = ["VIADD R4, R4, 0x1"] * 5
    for i, op in enumerate(ops):
        lines.append("        /*%04x*/                   %s ;" % (16 + 16 * i, op))
    lines.append("        /*%04x*/               @!P0 BRA 0x10 ;"
                 % (16 + 16 * len(ops)))
    lines.append("        /*%04x*/                   EXIT ;"
                 % (32 + 16 * len(ops)))
    return lines


def test_k3_sass_report_counts_cells(monkeypatch):
    """K3's SASS reading in ``chip_smoke.py``: a pass of the lane-group
    kernel's step loop is K3_ROWS cells; the mangled names give (has_nm,
    tie, G), and other functions are left out."""
    import chip_smoke
    from fastx_toolkit_tpu_torch.kernels.align_cuda import K3_ROWS

    k3 = ("_ZN41_GLOBAL__N__x_15_align_packed_cu_y19align_packed_kernel"
          "ILb1ELb0ELi4EEEvPKjS2_PKiNS_12AdapterCodesEiiiPi")
    monkeypatch.setattr(probe, "sass_functions", lambda obj: {
        k3: _k3_body(), "_Z5otheri": _k3_body()})
    rep = chip_smoke.lane_sass_report("align_packed.cu", "unused.o")
    assert set(rep) == {(True, False, 4)}
    assert rep[(True, False, 4)]["instr"] == 6
    assert rep[(True, False, 4)]["cells"] == K3_ROWS
    assert rep[(True, False, 4)]["instr_per_cell"] == 6 / K3_ROWS


def test_k4_sass_report_counts_cells(monkeypatch):
    """The same reading for K4's lane-group kernel: the mangled names give
    (table, G, K), a pass of the step loop is K cells, and neither K3's
    kernel nor the one-thread-per-read route is counted."""
    import chip_smoke

    k4 = ("_ZN41_GLOBAL__N__x_17_align_unpacked_cu_y21align_unpacked_kernel"
          "ILb1ELi4ELi6EEEvPKhPKiNS_11AdapterRowsEiiiPi")
    serial = ("_ZN41_GLOBAL__N__x_17_align_unpacked_cu_y19align_serial_kernel"
              "ILb1EEEvPKhPKiS2_iiiPiS5_")
    k3 = ("_ZN41_GLOBAL__N__x_15_align_packed_cu_y19align_packed_kernel"
          "ILb1ELb0ELi4EEEvPKjS2_PKiNS_12AdapterCodesEiiiPi")
    monkeypatch.setattr(probe, "sass_functions", lambda obj: {
        k4: _k3_body(), serial: _k3_body(), k3: _k3_body()})
    rep = chip_smoke.lane_sass_report("align_unpacked.cu", "unused.o")
    assert set(rep) == {(True, 4, 6)}
    assert rep[(True, 4, 6)]["cells"] == 6
    assert rep[(True, 4, 6)]["instr_per_cell"] == 1.0


def _loops_body(first, second):
    """A SASS body of two innermost loops, opcodes ``first`` and then
    ``second`` (one instruction each, then the loop's branch)."""
    lines, addr = [], 0
    for ops in (first, second):
        top = addr
        for op in ops:
            lines.append("        /*%04x*/                   %s R4, R4 ;"
                         % (addr, op))
            addr += 16
        lines.append("        /*%04x*/               @!P0 BRA 0x%x ;"
                     % (addr, top))
        addr += 16
    lines.append("        /*%04x*/                   EXIT ;" % addr)
    return lines


def test_count_sass_report_counts_bases(monkeypatch):
    """K5's and K2's SASS reading in ``chip_smoke.py``: the loop that holds
    the tally's ATOMS (one a base) or K2's POPC (five a 16-base word with
    the N plane, four without), not a larger loop beside it; the mangled
    names give (kernel, flag)."""
    import chip_smoke

    body = _loops_body(["LDS", "IMAD", "ATOMS", "LDS", "IMAD", "ATOMS"],
                       ["LDS"] * 20)
    assert probe._hot_loop(body) == {"LDS": 20, "BRA": 1}
    assert probe._hot_loop(body, need="ATOMS") == {"LDS": 2, "IMAD": 2,
                                                   "ATOMS": 2, "BRA": 1}
    tile = ("_ZN46_GLOBAL__N__x_13_stats_hist_cu_y17stats_tile_kernelILb1EEEv"
            "PKhPKaPKiiiiNS_4PlanEPi")
    tiled = ("_ZN46_GLOBAL__N__x_13_stats_hist_cu_y18stats_tiled_kernelILb0EE"
             "EvPKhPKaPKiiiiiPi")
    monkeypatch.setattr(probe, "sass_functions",
                        lambda obj: {tile: body, tiled: body})
    rep = chip_smoke.count_sass_report("stats_hist.cu", "unused.o")
    assert set(rep) == {("stats_tile", True), ("stats_tiled", False)}
    assert rep[("stats_tile", True)]["bases"] == 2
    assert rep[("stats_tile", True)]["instr_per_base"] == 3.5
    k2 = ("_ZN49_GLOBAL__N__x_16_packed_counts_cu_y20packed_counts_kernel"
          "ILb1EEEvPKjS2_PKiiiPiS5_")
    k2_body = _loops_body(["POPC"] * 10 + ["LOP3"] * 21, ["LDS"] * 40)
    monkeypatch.setattr(probe, "sass_functions", lambda obj: {k2: k2_body})
    rep = chip_smoke.count_sass_report("packed_counts.cu", "unused.o")
    assert rep[("packed_counts", True)]["bases"] == 32
    assert rep[("packed_counts", True)]["instr_per_base"] == 1.0

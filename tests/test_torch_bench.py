"""The port's bench (``fastx_toolkit_tpu_torch/bench.py``) against the
repository's ``bench.py``: the same configs, the same bytes from the line
engine and from its stubs on a seeded lane, configs 3 and 5 on both
engines equal to the port's CLIs, their device-resident steps on the
tools' own inputs, the speed-of-light counts at a small shape, and the
CPU rules (no card: exit non-zero unless the CPU is asked for; on the CPU
every quantity of the card is null)."""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import bench
from fastx_toolkit_tpu.core import native as ref_native
from fastx_toolkit_tpu.engine.lines import LineEngines as RefEngines
from fastx_toolkit_tpu_torch import bench as port
from fastx_toolkit_tpu_torch.engine.lines import LineEngines
from test_torch_clipper_cli import run_cli_in_process

pytestmark = pytest.mark.skipif(
    port.native.LIB is None or ref_native.LIB is None,
    reason="native codec unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FASTX_BENCH_ITERS", "1")
    for k in ("FASTX_STATS_PATH", "FASTX_COLLAPSE_PATH", "FASTX_BENCH_DUMP"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _lines(argv):
    """The JSON lines ``port.main(argv)`` prints, and its status."""
    out = io.StringIO()
    with redirect_stdout(out):
        status = port.main(argv)
    return status, [json.loads(s) for s in out.getvalue().splitlines()]


@pytest.mark.parametrize("n", range(6))
def test_config_cfg_matches_bench(n):
    ref_cfg, ref_fastq = bench.config_cfg(n)
    cfg, fastq = port.config_cfg(n)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert fastq == ref_fastq
    assert port.METRIC == bench.METRIC and port.C_CMDS == bench.C_CMDS


@pytest.mark.parametrize("n", [0, 1, 2, 4])
def test_run_once_auto_matches_bench(n, cpu):
    cpu.setattr(bench, "CHUNK", 512)
    cpu.setattr(port, "CHUNK", 512)
    data = port.synth_lane_bytes(2048, 100)
    ref_cfg, fastq = bench.config_cfg(n)
    cfg, _ = port.config_cfg(n)
    ref_arena, arena = (np.zeros(len(data) + 4096, np.uint8)
                        for _ in range(2))
    want = bench.run_once_auto(data, RefEngines(ref_cfg), ref_cfg, ref_arena,
                               out_fastq=fastq)
    got = port.run_once_auto(data, LineEngines(cfg, "cpu"), cfg, arena,
                             out_fastq=fastq)
    assert got == want and 0 < got[1] < len(data)
    assert bytes(arena[:got[1]]) == bytes(ref_arena[:want[1]])


@pytest.mark.parametrize("chunk", [700, 4096],
                         ids=["run_once_auto", "one_chunk"])
def test_stub_runs_match_bench(chunk, cpu):
    cpu.setattr(bench, "CHUNK", chunk)
    cpu.setattr(port, "CHUNK", chunk)
    data = port.synth_lane_bytes(3000, 100, seed=3)
    ref_cfg, cfg = bench.config_cfg(0)[0], port.config_cfg(0)[0]
    ref_arena, arena = (np.zeros(len(data) + 4096, np.uint8)
                        for _ in range(2))
    want = bench.run_once_auto(data, bench.StubEngines(), ref_cfg, ref_arena)
    got = port.run_once_auto(data, port.StubEngines(), cfg, arena)
    assert got == want == (3000, got[1])
    assert bytes(arena[:got[1]]) == bytes(ref_arena[:want[1]])


@pytest.mark.parametrize("n,tool,env,engine", [
    (3, "fastx_quality_stats", "FASTX_STATS_PATH", "host"),
    (3, "fastx_quality_stats", "FASTX_STATS_PATH", "device"),
    (5, "fastx_collapser", "FASTX_COLLAPSE_PATH", "host"),
    (5, "fastx_collapser", "FASTX_COLLAPSE_PATH", "device"),
])
def test_configs_3_and_5_match_the_clis(n, tool, env, engine, cpu, tmp_path):
    cpu.setattr(port, "N_READS", 4096)
    cpu.setattr(port, "CHUNK", 1500)
    cpu.setenv(env, engine)
    cpu.setenv("FASTX_BENCH_DUMP", str(tmp_path / "dump"))
    launches = port_launches()
    status, lines = _lines(["--config", str(n)])
    assert status == 0
    assert [ln["metric"] for ln in lines] == [port.METRIC[n]]
    assert lines[0]["reads"] == 4096 and lines[0]["value"] > 0
    assert lines[0]["engine"] == engine
    cwd = tmp_path / "cli"
    cwd.mkdir()
    want = run_cli_in_process("fastx_toolkit_tpu_torch", tool, ["-Q", "33"],
                              port.synth_lane_bytes(4096, 100), cwd)
    assert want["rc"] == 0
    assert (tmp_path / "dump").read_bytes() == want["stdout"]
    assert port_launches() == launches  # CPU tensors: the plain versions


@pytest.mark.parametrize("n", [3, 5])
def test_device_configs_3_and_5_time_the_tools_steps(n, cpu, monkeypatch):
    """``--device --config 3`` takes K5b's inputs from the stats tool's
    device engine, ``--config 5`` the collapser's ``pack_words`` keys."""
    from fastx_toolkit_tpu_torch.cli.tools import fastx_quality_stats
    from fastx_toolkit_tpu_torch.ops import collapse

    cpu.setattr(port, "CHUNK", 256)
    seen = []
    fn = (fastx_quality_stats, "b2_inputs") if n == 3 else \
        (collapse, "pack_words")
    real = getattr(*fn)
    monkeypatch.setattr(*fn, lambda *a: seen.append(a) or real(*a))
    status, lines = _lines(["--device", "--config", str(n)])
    assert status == 0 and len(seen) == 1
    assert [ln["metric"] for ln in lines] == [
        port.METRIC[n] + "_device_resident", "speed_of_light_config%d" % n]
    assert lines[0]["value"] is None and lines[1]["pct_of_sol"] is None
    work = lines[1]["work"]
    assert work["reads"] == 256
    if n == 3:
        assert work["counted_bases"] == 256 * 100
    else:
        assert work["key_words"] == 25  # one byte a base, 4 a word


def port_launches():
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    return stats_cuda.launches, stats_cuda.b2_launches


def _sol_inputs(n):
    """A small shape: 4 ACGT reads of 40 columns, qualities all 30 (no
    trim), lengths 40, 33, 0 and 7."""
    rng = np.random.default_rng(9)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(4, 40))
    quals = np.full((4, 40), 30, np.int8)
    lengths = np.array([40, 33, 0, 7])
    cfg = port.config_cfg(n)[0]
    b2, planes = port.pack_batch2(bases, quals, cfg, n_plane=False)
    if n == 3:
        return [torch.from_numpy(a) for a in (b2, quals,
                                              lengths.astype(np.int32))]
    if n == 5:
        return [torch.zeros((4, 3), dtype=torch.int32), torch.ones(4),
                torch.arange(4)]
    return [torch.from_numpy(a) for a in (b2, planes,
                                          lengths.astype(np.int16))]


# by hand: b2 10 bytes a read; one 5-byte quality plane where a threshold
# is shipped (the chains' thresholds are all 20); 2 + 6 bytes a read of
# lengths and decisions; 80 bases in all, 17 adapter rows; the filter and
# the trimmer read the plane (12 operations a byte each), K1 20 a cell,
# K2 5 a base.  K5b: 80 bases' codes (80 // 4) and qualities, 4 lengths,
# 40 x 654 int32 bins.  Collapse: 3 words a read, 48 operations a word,
# 8 passes x 2 x 16 bytes and 4 x 2 x 12 of the sorts, 9 bytes out.
SOL_HAND = {
    0: (4 * 12 * 2 * 5 + 80 * 17 * 20 + 80 * 5, 4 * (10 + 5 + 2 + 6)),
    1: (80 * 5, 4 * (10 + 2 + 6)),
    2: (4 * 12 * 2 * 5, 4 * (10 + 5 + 2 + 6)),
    3: (80 * 5, 80 // 4 + 80 + 4 * 4 + 4 * 40 * 654),
    4: (80 * 17 * 20 + 80 * 5, 4 * (10 + 2 + 6)),
    5: (4 * 3 * 48, 4 * (4 * 3 + 8 * 2 * 16 + 4 * 2 * 12 + 9)),
}


@pytest.mark.parametrize("n", range(6))
def test_sol_accounting_counts(n, cpu):
    out = io.StringIO()
    with redirect_stdout(out):
        rec = port.sol_accounting(n, None, port.step_work(n, _sol_inputs(n)))
    assert json.loads(out.getvalue()) == rec
    assert (rec["sol_ops"], rec["sol_bytes"]) == SOL_HAND[n]
    assert rec["sol_bytes_per_read"] == SOL_HAND[n][1] / 4
    assert rec["metric"] == "speed_of_light_config%d" % n
    assert rec["device"] == {"platform": "cpu"}
    assert rec["pct_of_sol"] is None and rec["sol_reads_per_sec"] is None


def test_roofline():
    assert port.roofline(33.45e9, 1.0, 33.45e12) == (1.0, "operations")
    assert port.roofline(1.0, 3.35e9, 33.45e12) == (1.0, "bytes")


def test_exits_without_a_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card exit cannot be "
                    "shown here")
    env = {k: v for k, v in os.environ.items() if k != "FASTX_TORCH_DEVICE"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "fastx_toolkit_tpu_torch.bench",
                        "--config", "1"], capture_output=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert r.stdout == b"" and b"CUDA is not available" in r.stderr


def test_cpu_prints_null_for_the_cards_quantities(cpu, tmp_path):
    cpu.setattr(port, "N_READS", 1024)
    cpu.setattr(port, "CHUNK", 512)
    status, head = _lines([])
    assert status == 0 and len(head) == 1
    rec = head[0]
    assert rec["metric"] == bench.METRIC[0] and rec["value"] > 0
    for k in ("link_MBps_median", "device_resident_reads_per_sec",
              "device_busy_ms", "device_busy_pct"):
        assert rec[k] is None, k
    assert rec["iter_link_MBps"] == [None]
    status, dev = _lines(["--device", "--config", "0"])
    assert status == 0
    assert [d["metric"] for d in dev] == [
        "reads_per_sec_device_resident_fused_step", "speed_of_light_config0",
        "device_stage_decomposition"]
    assert dev[0]["value"] is None and dev[0]["with_tie_flag_reads_per_sec"] \
        is None
    assert dev[1]["pct_of_sol"] is None and dev[1]["sol_ops"] > 0
    assert dev[2]["dp_share_pct"] is None
    for rec in head + dev:
        assert rec["device"] == {"platform": "cpu"}
        assert "vs_baseline" not in rec


def test_host_mode_and_cbaseline_without_the_tree(cpu, tmp_path, capsys):
    cpu.setattr(port, "N_READS", 2000)
    status, lines = _lines(["--host"])
    assert status == 0
    assert [ln["metric"] for ln in lines] == [
        "reads_per_sec_host_codec_only_lines"]
    assert lines[0]["reads"] == 2000 and lines[0]["value"] > 0
    cpu.setattr(port, "REFERENCE_SRC", str(tmp_path / "absent"))
    status, lines = _lines(["--cbaseline"])
    assert status != 0 and lines == []
    assert "reference C sources are not at" in capsys.readouterr().err

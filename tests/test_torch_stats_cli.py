"""The port's ``fastx_quality_stats`` CLI against the JAX package's, both
run in process (``run_cli_in_process``): identical stdout, stderr, exit
status and output files, on the host and on the device engine
(``FASTX_STATS_PATH``; the device engine on the CPU runs K5's plain
version and the plain scatter).  Cases: the galaxy fixture in the old and
the ``-N`` format (also against its golden outputs), a seeded lane read
in several blocks, FASTA with collapsed counts (the reference's
out-of-bounds quantile walk), ``-o`` to a file with ``-z``, numeric
qualities, and a usage error."""

import os

import numpy as np
import pytest

from fastx_toolkit_tpu_torch import synth
from fastx_toolkit_tpu_torch.core import native

from test_torch_clipper_cli import run_cli_in_process

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="native codec unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "galaxy", "test-data")
ENGINES = ("host", "device")


def _fixture(name):
    with open(os.path.join(TD, name), "rb") as fh:
        return fh.read()


def _compare(argv, data, tmp_path, monkeypatch, engine, block_bytes=None):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FASTX_STATS_PATH", engine)
    if block_bytes:
        monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", str(block_bytes))
    ref = run_cli_in_process("fastx_toolkit_tpu", "fastx_quality_stats",
                             argv, data, tmp_path)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", "fastx_quality_stats",
                             argv, data, tmp_path)
    assert got == ref
    return ref


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("argv,golden", [
    (["-Q", "64"], "fastq_stats1.out"),
    (["-Q", "64", "-N"], "fastq_stats1_ng.out"),
])
def test_galaxy_fixture_matches_reference_and_golden(argv, golden, engine,
                                                     tmp_path, monkeypatch):
    ref = _compare(argv, _fixture("fastq_stats1.fastq"), tmp_path,
                   monkeypatch, engine)
    assert ref["rc"] == 0 and ref["stdout"] == _fixture(golden)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("argv", [["-Q", "33"], ["-Q", "33", "-N"]])
def test_lane_in_several_blocks_matches_reference(argv, engine, tmp_path,
                                                  monkeypatch):
    data = synth.synth_lane_bytes(600, 100, seed=17)
    ref = _compare(argv, data, tmp_path, monkeypatch, engine,
                   block_bytes=20000)
    assert ref["rc"] == 0 and ref["stdout"].count(b"\n") == 101


def _collapsed_fasta(seed, n):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                         int(rng.integers(5, 40))).tobytes()
        recs.append(b">%d-%d\n%s\n" % (i + 1, int(rng.integers(1, 8)), seq))
    return b"".join(recs)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("argv", [["-N"], ["-z", "-o", "stats.txt"]])
def test_collapsed_fasta_matches_reference(argv, engine, tmp_path,
                                           monkeypatch):
    ref = _compare(argv, _collapsed_fasta(6, 80), tmp_path, monkeypatch,
                   engine)
    assert ref["rc"] == 0
    if "-o" in argv:
        assert ref["stdout"] == b"" and ref["stats.txt"].startswith(b"column")


@pytest.mark.parametrize("engine", ENGINES)
def test_numeric_qualities_and_file_output_match_reference(engine, tmp_path,
                                                           monkeypatch):
    rng = np.random.default_rng(12)
    recs = []
    for i in range(30):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 20).tobytes()
        qual = " ".join(str(int(v)) for v in rng.integers(-15, 41, 20))
        recs.append(b"@n%d\n%s\n+\n%s\n" % (i, seq, qual.encode()))
    ref = _compare(["-N", "-o", "out.tsv"], b"".join(recs), tmp_path,
                   monkeypatch, engine)
    assert ref["rc"] == 0 and ref["out.tsv"].startswith(b"cycle\tmax_count")


@pytest.mark.parametrize("engine", ENGINES)
def test_usage_error_matches_reference(engine, tmp_path, monkeypatch):
    ref = _compare(["-x"], b"", tmp_path, monkeypatch, engine)
    assert ref["rc"] == 1


@pytest.mark.parametrize("lane,kernel", [("acgt", "stats_hist_b2"),
                                         ("with_n", "stats_hist")])
def test_device_engine_sends_pure_acgt_blocks_to_k5b(lane, kernel, tmp_path,
                                                     monkeypatch):
    """The device engine's route: a block of pure-ACGT reads goes 2-bit
    packed to K5b, a block with an N to K5, each with the reference's
    bytes."""
    from fastx_toolkit_tpu_torch.cli.tools import fastx_quality_stats
    from fastx_toolkit_tpu_torch.kernels import stats_cuda

    calls = []
    for mod, name in ((fastx_quality_stats, "stats_hist_b2"),
                      (stats_cuda, "stats_hist")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real: (
            calls.append(_n) or _f(*a)))
    data = (synth.synth_lane_bytes(500, 60, seed=4) if lane == "acgt"
            else synth.synth_small_rna_lane_bytes(500, 50, seed=4))
    ref = _compare(["-Q", "33"], data, tmp_path, monkeypatch, "device",
                   block_bytes=30000)
    assert ref["rc"] == 0
    assert len(calls) >= 2 and set(calls) == {kernel}

"""The port's eight per-read CLIs (``fastq_quality_filter``,
``fastq_quality_trimmer``, ``fastq_masker``, ``fastx_trimmer``,
``fastq_to_fasta``, ``fastx_artifacts_filter``,
``fastx_reverse_complement``, ``fasta_nucleotide_changer``) against the
JAX package's, both run in process (``run_cli_in_process``): identical
stdout, stderr, exit status and output files, on each case under the
default engine (the raw-line fast path where the tool has one) and under
``FASTX_LINEPATH=off`` (the classic parse -> transform path, CPU tensors
here).  Cases: the galaxy rows of ``test_galaxy_testdata._C_CHECKED``
(also against their goldens), a seeded lane read in several blocks,
numeric qualities and a malformed record (which the classic parser takes,
with the reference's error text), ``FASTX_TPU_NO_LINEPATH=1``, and which
path ran."""

import os

import numpy as np
import pytest

from fastx_toolkit_tpu_torch import synth
from fastx_toolkit_tpu_torch.core import native
from fastx_toolkit_tpu_torch.ops import transforms

from test_galaxy_testdata import _C_CHECKED
from test_torch_clipper_cli import run_cli_in_process

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="native codec unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "galaxy", "test-data")
TOOLS = ("fastq_quality_filter", "fastq_quality_trimmer", "fastq_masker",
         "fastx_trimmer", "fastq_to_fasta", "fastx_artifacts_filter",
         "fastx_reverse_complement", "fasta_nucleotide_changer")
ENGINES = ({}, {"FASTX_LINEPATH": "off"})
ENGINE_IDS = ("default", "linepath-off")
GALAXY = [row for row in _C_CHECKED if row[0] in TOOLS]
# each tool on a FASTQ lane (the nucleotide changer on its FASTA form)
LANE_ARGV = {
    "fastq_quality_filter": ["-Q", "33", "-q", "20", "-p", "50", "-v"],
    "fastq_quality_trimmer": ["-Q", "33", "-t", "20", "-l", "10", "-v"],
    "fastq_masker": ["-Q", "33", "-q", "25", "-r", "x", "-v"],
    "fastx_trimmer": ["-Q", "33", "-f", "3", "-l", "40", "-v"],
    "fastq_to_fasta": ["-Q", "33", "-v"],
    "fastx_artifacts_filter": ["-Q", "33", "-v"],
    "fastx_reverse_complement": ["-Q", "33", "-v"],
    "fasta_nucleotide_changer": ["-r", "-v"],
}
# the transform each tool's classic path calls
TRANSFORM = {
    "fastq_quality_filter": "quality_filter_keep",
    "fastq_quality_trimmer": "quality_trimmer",
    "fastq_masker": "masker",
    "fastx_trimmer": "trimmer",
    "fastq_to_fasta": "fastq_to_fasta_keep",
    "fastx_artifacts_filter": "artifacts_keep",
}


def _fixture(name):
    with open(os.path.join(TD, name), "rb") as fh:
        return fh.read()


def _compare(tool, argv, data, tmp_path, monkeypatch, env):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = run_cli_in_process("fastx_toolkit_tpu", tool, argv, data, tmp_path)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", tool, argv, data,
                             tmp_path)
    assert got == ref
    return ref


def _lane(seed=4, n=500):
    """Small-RNA reads (Ns, ragged lengths, adapter-only reads) plus
    near-homopolymer artifacts every 25th read."""
    data = synth.synth_small_rna_lane_bytes(n, 50, seed=seed)
    lines = data.split(b"\n")
    for i in range(0, n, 25):
        lines[4 * i + 1] = b"A" * 40 + b"CGT"
        lines[4 * i + 3] = lines[4 * i + 3][:43].ljust(43, b"I")
    return b"\n".join(lines)


def _as_fasta(fastq):
    lines = fastq.split(b"\n")
    return b"".join(b">%s\n%s\n" % (n[1:], s)
                    for n, s in zip(lines[0::4], lines[1::4]) if n)


@pytest.mark.parametrize("env", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("tool,argv,inp,golden", GALAXY,
                         ids=[g for *_, g in GALAXY])
def test_galaxy_rows_match_reference_and_golden(tool, argv, inp, golden, env,
                                                tmp_path, monkeypatch):
    ref = _compare(tool, argv, _fixture(inp), tmp_path, monkeypatch, env)
    assert ref["rc"] == 0 and ref["stdout"] == _fixture(golden)


@pytest.mark.parametrize("env", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("tool", TOOLS)
def test_lane_in_several_blocks_matches_reference(tool, env, tmp_path,
                                                  monkeypatch):
    data = _lane()
    if tool == "fasta_nucleotide_changer":
        data = _as_fasta(data)
    ref = _compare(tool, LANE_ARGV[tool], data, tmp_path, monkeypatch,
                   dict(env, FASTX_TPU_BLOCK_BYTES="7000"))
    assert ref["rc"] == 0 and ref["stderr"]


@pytest.mark.parametrize("env", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("tool,argv", [
    ("fastx_trimmer", ["-t", "5", "-m", "20", "-v", "-o", "out.fq"]),
    ("fastx_trimmer", ["-f", "40", "-v"]),
    ("fastq_to_fasta", ["-Q", "33", "-n", "-r", "-v"]),
    ("fastq_masker", ["-Q", "33"]),
    ("fastx_artifacts_filter", ["-Q", "33", "-z", "-o", "out.fq.gz"]),
])
def test_more_flags_match_reference(tool, argv, env, tmp_path, monkeypatch):
    ref = _compare(tool, argv, _lane(seed=6, n=300), tmp_path, monkeypatch,
                   dict(env, FASTX_TPU_BLOCK_BYTES="9000"))
    assert ref["rc"] == 0


@pytest.mark.parametrize("env", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("tool", ["fastx_trimmer", "fastx_artifacts_filter",
                                  "fastx_reverse_complement"])
def test_collapsed_fasta_matches_reference(tool, env, tmp_path, monkeypatch):
    """FASTA with ``>rank-count`` names: the reports weigh by the counts."""
    data = _fixture("fasta_collapser1.out") + _fixture("fastx_artifacts1.fasta")
    argv = ["-v", "-l", "9"] if tool == "fastx_trimmer" else ["-v"]
    ref = _compare(tool, argv, data, tmp_path, monkeypatch, env)
    assert ref["rc"] == 0


def _numeric(seed, n=30):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), 24).tobytes()
        qual = " ".join(str(int(v)) for v in rng.integers(-5, 41, 24))
        recs.append(b"@n%d\n%s\n+\n%s\n" % (i, seq, qual.encode()))
    return b"".join(recs)


def _malformed(seed):
    lines = _lane(seed, 120).split(b"\n")
    lines[4 * 70 + 1] = lines[4 * 70 + 1][:5] + b"X" + lines[4 * 70 + 1][6:]
    return b"\n".join(lines)


@pytest.mark.parametrize("env", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("tool", TOOLS)
def test_numeric_qualities_and_malformed_match_reference(tool, env, tmp_path,
                                                         monkeypatch):
    argv = [a for a in LANE_ARGV[tool] if a not in ("-Q", "33")]
    env = dict(env, FASTX_TPU_BLOCK_BYTES="4000")
    ok = _compare(tool, argv, _numeric(2), tmp_path, monkeypatch, env)
    assert ok["rc"] == 0
    bad = _compare(tool, argv, _malformed(3), tmp_path, monkeypatch, env)
    assert bad["rc"] == 1 and "line 282" in bad["stderr"]


@pytest.mark.parametrize("argv,data", [
    (["-d", "-v"], b">a\nACGU\n>b\nACGT\n>c\nAUUU\n"),
    (["-r"], b">a\nACGT\n>b\nACGU\n"),
    ([], b">a\nACGT\n"),
    (["-r", "-d"], b""),
])
def test_nucleotide_changer_abort_and_usage_match_reference(argv, data,
                                                            tmp_path,
                                                            monkeypatch):
    ref = _compare("fasta_nucleotide_changer", argv, data, tmp_path,
                   monkeypatch, {})
    assert ref["rc"] == 1


@pytest.mark.parametrize("tool,argv", [
    ("fastq_quality_filter", ["-q", "20", "-p", "0"]),
    ("fastq_quality_trimmer", ["-l", "5"]),
    ("fastq_masker", ["-r", "xy"]),
    ("fastx_trimmer", ["-t", "3", "-f", "2"]),
    ("fastq_to_fasta", ["-x"]),
    ("fastx_reverse_complement", ["-i", "missing.fq"]),
])
def test_usage_errors_match_reference(tool, argv, tmp_path, monkeypatch):
    ref = _compare(tool, argv, b"", tmp_path, monkeypatch, {})
    assert ref["rc"] == 1


@pytest.mark.parametrize("tool", ["fastq_quality_filter", "fastq_to_fasta",
                                  "fastq_masker"])
def test_empty_input_matches_reference(tool, tmp_path, monkeypatch):
    ref = _compare(tool, LANE_ARGV[tool], b"", tmp_path, monkeypatch, {})
    assert ref["rc"] == 1


def test_no_linepath_env_matches_reference(tmp_path, monkeypatch):
    ref = _compare("fastq_quality_trimmer", LANE_ARGV["fastq_quality_trimmer"],
                   _lane(9), tmp_path, monkeypatch,
                   {"FASTX_TPU_NO_LINEPATH": "1"})
    assert ref["rc"] == 0


@pytest.mark.parametrize("env,classic", [
    ({}, False), ({"FASTX_LINEPATH": "off"}, True),
    ({"FASTX_LINEPATH": "on"}, False), ({"FASTX_TPU_NO_LINEPATH": "1"}, True),
])
@pytest.mark.parametrize("tool", sorted(TRANSFORM))
def test_engine_choice_takes_its_path(tool, env, classic, tmp_path,
                                      monkeypatch):
    """On a clean lane the fast path calls no transform; the classic path
    calls the tool's transform on every block."""
    calls = []
    real = getattr(transforms, TRANSFORM[tool])
    monkeypatch.setattr(transforms, TRANSFORM[tool],
                        lambda *a, **k: calls.append(a[0].device) or real(*a, **k))
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", "6000")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = [a for a in LANE_ARGV[tool] if a != "-r"]  # -r skips the fast path
    data = synth.synth_lane_bytes(200, 40, seed=1)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", tool, argv, data,
                             tmp_path)
    assert got["rc"] == 0
    assert len(calls) == (len(data) // 6000 + 1 if classic else 0)
    assert all(d.type == "cpu" for d in calls)

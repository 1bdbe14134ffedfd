"""The port's ``fastx_collapser``, ``fastx_uncollapser`` and
``fastx_renamer`` CLIs against the JAX package's, both run in process
(``run_cli_in_process``): identical stdout, stderr, exit status and
output files.  The collapser runs on both engines
(``FASTX_COLLAPSE_PATH=host|device``; the device engine on the CPU runs
``ops/collapse.collapse_batch`` on CPU tensors) on the galaxy fixture
(also against its golden), a seeded duplicated FASTQ lane read in
several blocks, collapsed FASTA with counts (``counts_from_names``),
``-v``, ``-o`` with ``-z``, empty input, a usage error, and under
``FASTX_COLLAPSE_EXACT`` / ``FASTX_COLLAPSE_WEAK_HASH``.  The
uncollapser and renamer run on their galaxy fixtures (and goldens) and
their error cases; uncollapsing the port's collapsed output gives back
the input's multiset of sequences."""

import collections
import os

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


def _compare(tool, argv, data, tmp_path, monkeypatch, env=None):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    ref = run_cli_in_process("fastx_toolkit_tpu", tool, argv, data, tmp_path)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", tool, argv, data,
                             tmp_path)
    assert got == ref
    return ref


def _collapse(argv, data, tmp_path, monkeypatch, engine, **env):
    return _compare("fastx_collapser", argv, data, tmp_path, monkeypatch,
                    dict(env, FASTX_COLLAPSE_PATH=engine))


def _lane(n=1500, pool=120, seed=11):
    return synth.synth_collapse_lane_bytes(n, pool=pool, seed=seed)


@pytest.mark.parametrize("engine", ENGINES)
def test_galaxy_fixture_matches_reference_and_golden(engine, tmp_path,
                                                     monkeypatch):
    ref = _collapse(["-Q", "64", "-v"], _fixture("fasta_collapser1.fasta"),
                    tmp_path, monkeypatch, engine)
    assert ref["rc"] == 0 and ref["stdout"] == _fixture("fasta_collapser1.out")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("block_bytes", [None, "9000"])
def test_duplicated_lane_in_blocks_matches_reference(engine, block_bytes,
                                                     tmp_path, monkeypatch):
    env = {"FASTX_TPU_BLOCK_BYTES": block_bytes} if block_bytes else {}
    ref = _collapse(["-Q", "33", "-v"], _lane(), tmp_path, monkeypatch,
                    engine, **env)
    assert ref["rc"] == 0
    assert ref["stderr"].startswith("Input: 1500 sequences (representing "
                                    "1500 reads)\n")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("env", [{"FASTX_COLLAPSE_EXACT": "1"},
                                 {"FASTX_COLLAPSE_WEAK_HASH": "1"}])
def test_exact_and_weak_hash_match_reference(engine, env, tmp_path,
                                             monkeypatch):
    ref = _collapse(["-v"], _lane(600, 50, seed=3), tmp_path, monkeypatch,
                    engine, FASTX_TPU_BLOCK_BYTES="12000", **env)
    assert ref["rc"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_collapsed_fasta_recollapse_matches_reference(engine, tmp_path,
                                                      monkeypatch):
    """A lane collapsed in two halves, the halves' FASTA concatenated and
    collapsed again: the counts come from the ``>rank-count`` names."""
    lane = _lane(1200, 80, seed=5)
    cut = lane.find(b"\n@r600\n") + 1
    halves = [_collapse([], part, tmp_path, monkeypatch, engine)["stdout"]
              for part in (lane[:cut], lane[cut:])]
    ref = _collapse(["-v"], b"".join(halves), tmp_path, monkeypatch, engine,
                    FASTX_TPU_BLOCK_BYTES="3000")
    assert ref["rc"] == 0
    once = _collapse([], lane, tmp_path, monkeypatch, engine)["stdout"]
    assert _seq_counts(ref["stdout"]) == _seq_counts(once)


def _seq_counts(fasta):
    """{sequence: count} of collapsed FASTA (ties may order differently
    when the first appearances differ)."""
    lines = fasta.split(b"\n")
    return {s: int(n.rsplit(b"-", 1)[1]) for n, s in zip(lines[::2],
                                                        lines[1::2])}


@pytest.mark.parametrize("engine", ENGINES)
def test_file_output_gzip_matches_reference(engine, tmp_path, monkeypatch):
    ref = _collapse(["-v", "-z", "-o", "out.fa.gz"], _lane(300, 40), tmp_path,
                    monkeypatch, engine)
    assert ref["rc"] == 0 and ref["out.fa.gz"][:2] == b"\x1f\x8b"
    assert ref["stdout"].startswith(b"Input: 300 sequences")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("argv,data", [([], b""), (["-x"], b""),
                                       (["-i", "missing.fq"], b"")])
def test_empty_input_and_usage_errors_match_reference(engine, argv, data,
                                                      tmp_path, monkeypatch):
    ref = _collapse(argv, data, tmp_path, monkeypatch, engine)
    assert ref["rc"] == 1


def test_uncollapse_of_collapsed_lane_restores_the_multiset(tmp_path,
                                                            monkeypatch):
    lane = _lane(900, 70, seed=8)
    coll = _collapse([], lane, tmp_path, monkeypatch, "device")["stdout"]
    back = _compare("fastx_uncollapser", ["-v"], coll, tmp_path,
                    monkeypatch)
    assert back["rc"] == 0
    assert (collections.Counter(back["stdout"].split(b"\n")[1::2])
            == collections.Counter(lane.split(b"\n")[1::4]))


@pytest.mark.parametrize("argv,inp,golden", [
    (["-v"], "fasta_uncollapser1.fasta", "fasta_uncollapser1.out"),
    (["-c", "10", "-v"], "fastx_seqid_uncollapse1.psl",
     "fastx_seqid_uncollapse1.out"),
])
def test_uncollapser_fixtures_match_reference_and_golden(argv, inp, golden,
                                                         tmp_path,
                                                         monkeypatch):
    ref = _compare("fastx_uncollapser", argv, _fixture(inp), tmp_path,
                   monkeypatch, {"FASTX_TPU_BLOCK_BYTES": "700"})
    assert ref["rc"] == 0 and ref["stdout"] == _fixture(golden)


@pytest.mark.parametrize("argv,data", [
    (["-c", "3"], b"a\t1-4\tx\nb\tc\n"),
    (["-c", "0"], b""),
    (["-c", "2", "-o", "out.tsv", "-v"], b"x\t2-3\ny\t7\nz\t5-\n\tq\t-1\n"),
    ([], b""),
])
def test_uncollapser_cases_match_reference(argv, data, tmp_path,
                                           monkeypatch):
    _compare("fastx_uncollapser", argv, data, tmp_path, monkeypatch)


@pytest.mark.parametrize("argv", [
    ["-Q", "64", "-n", "SEQ", "-v"],
    ["-Q", "64", "-n", "COUNT", "-v", "-o", "out.fq"],
    ["-n", "WHAT"],
])
def test_renamer_matches_reference(argv, tmp_path, monkeypatch):
    ref = _compare("fastx_renamer", argv, _fixture("fastx_renamer1.fastq"),
                   tmp_path, monkeypatch, {"FASTX_TPU_BLOCK_BYTES": "500"})
    if "SEQ" in argv:
        assert ref["rc"] == 0 and ref["stdout"] == _fixture("fastx_renamer1.out")
    assert ref["rc"] == (1 if "WHAT" in argv else 0)


def test_renamer_count_on_fasta_matches_reference(tmp_path, monkeypatch):
    ref = _compare("fastx_renamer", ["-n", "COUNT"],
                   _fixture("fasta_collapser1.fasta"), tmp_path, monkeypatch)
    assert ref["rc"] == 0 and ref["stdout"].startswith(b">1\n")

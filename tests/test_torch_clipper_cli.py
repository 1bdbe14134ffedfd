"""The port's ``fastx_clipper`` CLI against the JAX package's (both run
in process, as ``bin/fastx_clipper`` runs the reference's
``tool_main``): identical stdout, stderr and exit status on the
galaxy fixture with the galaxy wrapper's argv (and its golden output),
and on seeded lanes across every flag, with ``-D``/``-DD``, ``-v`` to
stderr and (with ``-o``) to stdout, a block size small enough that the
legacy stale-matrix carry crosses batches, FASTA input, and a usage
error."""

import importlib
import io
import os

import numpy as np
import pytest

from fastx_toolkit_tpu_torch.core import native
from fastx_toolkit_tpu_torch.synth import synth_small_rna_lane_bytes

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="native codec unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "galaxy", "test-data")
SMALL_RNA = "TGGAATTCTCGGGTGCCAAGG"
GALAXY_ARGV = ["-Q", "64", "-l", "15", "-a", "CAATTGGTTAATCCCCCTATATA",
               "-d", "0", "-v", "-n", "-c"]


def run_cli_in_process(package, tool, argv, data, cwd):
    """Run ``package``'s CLI ``tool`` in this process as its
    ``run_tool_main`` would, with ``data`` on stdin and ``cwd`` as the
    working directory: ``{"rc", "stdout", "stderr", <file>: bytes}``,
    every file the run left in ``cwd`` (removed after reading).  Text
    reports to stdout share the binary stdout's buffer in call order.
    In-process runs share one jax compilation cache across a test file,
    and XLA's own logging never reaches the captured streams."""
    common = importlib.import_module(package + ".cli.common")
    errors = importlib.import_module(package + ".core.errors")
    mod = importlib.import_module("%s.cli.tools.%s" % (package, tool))
    out, err = io.BytesIO(), io.StringIO()
    text = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    ctx = common.CliContext(prog=tool, stdin=io.BytesIO(data), stdout=out,
                            stderr=err, stdout_text=text)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        status = mod.tool_main(ctx, list(argv))
    except common.ExitWithStatus as e:
        status = e.status
    except errors.FastxError as e:
        err.write("%s: %s\n" % (tool, e))
        status = e.status
    finally:
        os.chdir(old)
        text.detach()
    res = {"rc": status, "stdout": out.getvalue(), "stderr": err.getvalue()}
    for name in sorted(os.listdir(cwd)):
        with open(os.path.join(cwd, name), "rb") as fh:
            res[name] = fh.read()
        os.unlink(os.path.join(cwd, name))
    return res


def _compare(argv, data, tmp_path, monkeypatch, block_bytes=None):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    if block_bytes:
        monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", str(block_bytes))
    ref = run_cli_in_process("fastx_toolkit_tpu", "fastx_clipper", argv,
                             data, tmp_path)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", "fastx_clipper",
                             argv, data, tmp_path)
    assert got == ref
    return ref


def test_galaxy_fixture_matches_reference_and_golden(tmp_path, monkeypatch):
    with open(os.path.join(TD, "fastx_clipper1.fastq"), "rb") as fh:
        data = fh.read()
    ref = _compare(GALAXY_ARGV, data, tmp_path, monkeypatch)
    assert ref["rc"] == 0
    with open(os.path.join(TD, "fastx_clipper1a.out"), "rb") as fh:
        assert ref["stdout"] == fh.read()


def _lane(n, seed):
    return synth_small_rna_lane_bytes(n, 50, seed=seed)


@pytest.mark.parametrize("argv,block_bytes", [
    (["-Q", "33", "-a", SMALL_RNA, "-l", "15", "-c", "-v"], 4096),
    (["-Q", "33", "-a", SMALL_RNA, "-d", "4", "-C", "-n", "-M", "6", "-v"],
     None),
    (["-Q", "33", "-a", "tggaattcucgg", "-k", "-l", "3", "-v", "-o",
      "out.fq"], 6000),
    (["-Q", "33", "-a", SMALL_RNA[:9], "-D"], None),
])
def test_lane_flags_match_reference(argv, block_bytes, tmp_path,
                                    monkeypatch):
    ref = _compare(argv, _lane(150, 5), tmp_path, monkeypatch, block_bytes)
    assert ref["rc"] == 0


def test_debug_matrix_and_fasta_input(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    recs = []
    for i in range(12):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                         int(rng.integers(6, 30))).tobytes()
        recs.append(b">s%d\n%s%s\n" % (i, seq, SMALL_RNA[:i + 3].encode()))
    ref = _compare(["-a", SMALL_RNA[:12], "-DD", "-v", "-l", "4"],
                   b"".join(recs), tmp_path, monkeypatch)
    assert ref["rc"] == 0 and b"Score-Matrix" in ref["stdout"]


def test_usage_error_matches_reference(tmp_path, monkeypatch):
    ref = _compare(["-M", "0"], b"", tmp_path, monkeypatch)
    assert ref["rc"] == 1

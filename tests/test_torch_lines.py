"""The port's streaming line engine and CLI against the JAX package's:
identical output bytes on a seeded lane whose dispatches spill across
render blocks, switch from N-free to N-bearing layout mid-stream and carry
tie_fragile reads (re-decided on the host); chunks and chains of the
classic path (numeric qualities, ``-v``, unmapped chains, wide or
non-ACGTN adapters, long reads, FASTA) give the reference's bytes, and a
malformed chunk raises the reference's exact error."""

import io
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

from fastx_toolkit_tpu.cli.tools._shared import BatchReader as RefReader
from fastx_toolkit_tpu.core import codec, native
from fastx_toolkit_tpu.core.errors import FastxError
from fastx_toolkit_tpu.engine import lines as ref_lines
from fastx_toolkit_tpu_torch.cli.tools._shared import BatchReader
from fastx_toolkit_tpu_torch.core.errors import FastxError as PortFastxError
from fastx_toolkit_tpu_torch.engine import lines as port_lines
from fastx_toolkit_tpu_torch.engine.pipeline import config_from_reference
from test_torch_clipper_cli import run_cli_in_process

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="native codec unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = b"CTGTAGGCACCATCAAT"
HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")


def _lane(n, seed, n_after=None, numeric_at=()):
    """Adapter-spiked FASTQ reads of 20-100 bp; reads from ``n_after`` on
    carry Ns (masked and input Ns make the DP's decimal ties)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(20, 101))
        alpha = b"ACGTN" if n_after is not None and i >= n_after else b"ACGT"
        p = [0.23] * 4 + [0.08] if len(alpha) == 5 else None
        seq = rng.choice(np.frombuffer(alpha, np.uint8), size=ln, p=p)
        if rng.random() < 0.5:
            pos = int(rng.integers(0, ln))
            ad = np.frombuffer(ADAPTER, np.uint8)[: ln - pos]
            seq[pos:pos + len(ad)] = ad
        q = np.clip(rng.normal(30, 8, ln), 2, 40).astype(np.int64)
        if i in numeric_at:
            qline = b" ".join(b"%d" % v for v in q)
        else:
            qline = (q + 33).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qline))
    return b"".join(recs)


def _ref_run(data, cfg, *, chunk_rows):
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    reader = RefReader(None, args, filetype=codec.FASTQ_ONLY,
                       stream=io.BytesIO(data))
    out = []
    n_in, n_out, _ = ref_lines.stream_pipeline_lines(
        reader, cfg, out_fastq=True, q_offset=33, write=out.append,
        chunk_rows=chunk_rows, engines=ref_lines.LineEngines(cfg))
    return n_in, n_out, b"".join(out)


def _port_run(data, cfg, *, chunk_rows, block_bytes=1 << 20, engines=None):
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                         block_bytes=block_bytes, stream=io.BytesIO(data))
    out = []
    n_in, n_out, _ = port_lines.stream_pipeline_lines(
        reader, cfg, out_fastq=True, q_offset=33, write=out.append,
        device="cpu", chunk_rows=chunk_rows, engines=engines)
    return n_in, n_out, b"".join(out)


def test_stream_matches_reference_with_spills_and_fixes():
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    ref_cfg = PipelineConfig(adapter=ADAPTER)
    cfg = config_from_reference(ref_cfg)
    data = _lane(2000, seed=21, n_after=700)
    ref = _ref_run(data, ref_cfg, chunk_rows=2048)
    assert ref[0] == 2000 and 0 < ref[1] < 2000
    # one dispatch, then spill-sized dispatches across small render blocks
    # (the first blocks are N-free, so the N-bearing layout flush runs)
    for chunk_rows, block_bytes in ((4096, 1 << 20), (97, 16384)):
        eng = port_lines.LineEngines(cfg, "cpu")
        got = _port_run(data, cfg, chunk_rows=chunk_rows,
                        block_bytes=block_bytes, engines=eng)
        assert got == ref, (chunk_rows, block_bytes)
        assert eng.fragile_rows > 0  # the host tie fix really ran


def _cli(argv, data, env_extra):
    # a fresh jax compile cache per run: entries another process wrote
    # make XLA log to stderr when they are loaded, which is not the tool's
    # output
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TPU_CHUNK="2048",
                   JAX_COMPILATION_CACHE_DIR=cache, **env_extra)
        return subprocess.run([sys.executable, *argv], input=data,
                              capture_output=True, env=env, cwd=ROOT,
                              timeout=600)


def test_cli_matches_reference_cli():
    data = _lane(1500, seed=22, n_after=400)
    ref = _cli([os.path.join(ROOT, "bin", "fastx_pipeline"), "-Q", "33",
                HEADLINE], data, {"JAX_PLATFORMS": "cpu"})
    got = _cli(["-m", "fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline",
                "-Q", "33", HEADLINE], data, {"FASTX_TORCH_DEVICE": "cpu"})
    assert ref.returncode == 0, ref.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == ref.stdout
    assert got.stdout.count(b"\n@r") > 100


def test_numeric_quality_chunk_is_not_implemented():
    """A chunk with numeric qualities takes the classic path, in read
    order between the fast spans: output equal to the reference's."""
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    ref_cfg = PipelineConfig()
    data = _lane(60, seed=23, numeric_at={30})
    ref = _ref_run(data, ref_cfg, chunk_rows=16)
    got = _port_run(data, config_from_reference(ref_cfg), chunk_rows=16,
                    block_bytes=2048)
    assert got == ref and ref[0] == 60
    # the numeric record keeps its representation
    assert any(b" " in q for q in ref[2].split(b"\n")[3::4])


def test_malformed_chunk_raises_reference_error():
    from fastx_toolkit_tpu.engine.pipeline import PipelineConfig

    data = _lane(40, seed=24)
    bad = data.replace(b"\n@r17\n", b"\nr17\n", 1)  # header without '@'
    with pytest.raises(FastxError) as ref_err:
        _ref_run(bad, PipelineConfig(), chunk_rows=64)
    with pytest.raises(PortFastxError) as port_err:
        _port_run(bad, port_lines.PipelineConfig(), chunk_rows=64)
    assert str(port_err.value) == str(ref_err.value)
    ref = _cli([os.path.join(ROOT, "bin", "fastx_pipeline"), "-Q", "33",
                HEADLINE], bad, {"JAX_PLATFORMS": "cpu"})
    got = _cli(["-m", "fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline",
                "-Q", "33", HEADLINE], bad, {"FASTX_TORCH_DEVICE": "cpu"})
    assert (got.returncode, got.stderr, got.stdout) == \
        (ref.returncode, ref.stderr, ref.stdout)
    assert ref.returncode == 1 and b"fastx_pipeline: " in ref.stderr


@pytest.mark.parametrize("argv,data", [
    (["-v", HEADLINE], None),                               # per-stage counts
    (["fastx_reverse_complement | fastx_artifacts_filter"], None),  # unmapped
    (["fastx_clipper -a " + "ACGT" * 8], None),             # adapter > 31
    (["fastx_clipper -a CTGTAGGCACCATCAAU"], None),         # outside ACGTN
    (["fastx_clipper -a CTGTAGGCA"], b"@a\n" + b"ACGT" * 130 + b"\n+\n"
     + b"I" * 520 + b"\n"),                                 # read > 511 bp
    (["fastx_clipper -a CTGTAGGCA"], b">a\nACGTACGT\n"),    # FASTA input
])
def test_cli_refuses_later_slices(argv, data, tmp_path, monkeypatch):
    """Chains and inputs beyond the headline line engine (``-v``, chains
    out of the canonical order, adapters over 31 bases or outside ACGTN,
    reads over 511 bp, FASTA input) give the reference CLI's stdout,
    stderr and status, both run in process.  The reference runs its
    classic per-batch loop (FASTX_TPU_NO_LINEPATH=1), which its own tests
    hold byte-identical to its line engine and which compiles far faster
    on the CPU for long reads."""
    if data is None:
        data = _lane(20, seed=25)
    argv = ["-Q", "33", *argv]
    monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")
    ref = run_cli_in_process("fastx_toolkit_tpu", "fastx_pipeline", argv,
                             data, tmp_path)
    monkeypatch.delenv("FASTX_TPU_NO_LINEPATH")
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    got = run_cli_in_process("fastx_toolkit_tpu_torch", "fastx_pipeline",
                             argv, data, tmp_path)
    assert got == ref
    assert ref["rc"] == 0 and ref["stdout"]

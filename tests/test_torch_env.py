"""The JAX package's environment switches that the port's CLIs honour, each
run in process against the JAX package's CLI with the same setting
(identical stdout, stderr and exit status):

* ``FASTX_TPU_NO_LINEPATH=1`` sends ``fastx_pipeline``'s FASTQ chains to
  the classic per-batch loop (its DP is K4's wrapper) instead of the
  raw-line engine (K1's); on the CPU the wrappers run their plain
  versions and count no launch, so the test watches which of them is
  called;
* ``FASTX_TPU_CLIPPER_CLEAN=1`` makes ``fastx_clipper`` align each read's
  own bases instead of emulating the reference's stale matrix, on a lane
  where the two give different output."""

import numpy as np
import pytest

from fastx_toolkit_tpu_torch.cli.tools import fastx_pipeline
from fastx_toolkit_tpu_torch.core import native
from fastx_toolkit_tpu_torch.engine import pipeline
from fastx_toolkit_tpu_torch.ops import clipper
from test_torch_clipper_cli import run_cli_in_process

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="native codec unavailable")

ADAPTER = b"CTGTAGGCACCATCAAT"
HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")


def _lane(n, seed, adapter=ADAPTER, lengths=(20, 101)):
    """Adapter-spiked FASTQ reads with qualities around 30."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(*lengths))
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln)
        if rng.random() < 0.5:
            pos = int(rng.integers(0, ln))
            ad = np.frombuffer(adapter, np.uint8)[: ln - pos]
            seq[pos:pos + len(ad)] = ad
        q = np.clip(rng.normal(30, 8, ln), 2, 40).astype(np.uint8) + 33
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    return b"".join(recs)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("no_linepath", [True, False])
def test_pipeline_no_linepath_takes_the_classic_loop(no_linepath, tmp_path,
                                                     monkeypatch):
    data = _lane(40, seed=61)
    argv = ["-Q", "33", HEADLINE]
    if no_linepath:
        monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")
    ref = run_cli_in_process("fastx_toolkit_tpu", "fastx_pipeline", argv,
                             data, tmp_path)
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    calls = {}
    _spy(monkeypatch, fastx_pipeline, "stream_pipeline_lines", calls)
    _spy(monkeypatch, pipeline, "align_batch_packed", calls)
    _spy(monkeypatch, clipper, "align_batch_unpacked", calls)
    got = run_cli_in_process("fastx_toolkit_tpu_torch", "fastx_pipeline",
                             argv, data, tmp_path)
    assert got == ref
    assert ref["rc"] == 0 and ref["stdout"].count(b"\n@r") > 5
    if no_linepath:
        assert calls.get("align_batch_unpacked", 0) > 0
        assert "stream_pipeline_lines" not in calls
        assert "align_batch_packed" not in calls
    else:
        assert calls.get("stream_pipeline_lines") == 1
        assert calls.get("align_batch_packed", 0) > 0
        assert "align_batch_unpacked" not in calls


@pytest.mark.parametrize("argv,block_bytes", [
    (["-Q", "33", "-a", "TGGAATTCTCGG", "-l", "15", "-c", "-v"], None),
    (["-Q", "33", "-a", "TGGAATTCTCGG", "-l", "5", "-d", "2", "-v"], 3000),
])
def test_clipper_clean_aligns_each_read(argv, block_bytes, tmp_path,
                                        monkeypatch):
    """Short adapter-free reads after long reads that end in the adapter:
    the legacy emulation aligns the stale tail of the longer read before
    and clips, the clean mode does not, so the two outputs differ; each
    equals the JAX package's (with ``-d`` and a small block, across
    batches)."""
    rng = np.random.default_rng(71)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(40):
        if i % 2:
            seq = rng.choice(alpha, 20).tobytes()
        else:
            seq = rng.choice(alpha, 40).tobytes() + b"TGGAATTCTCGGGTGCC"
        q = (rng.integers(20, 41, len(seq)) + 33).astype(np.uint8).tobytes()
        recs.append(b"@s%d\n%s\n+\n%s\n" % (i, seq, q))
    data = b"".join(recs)
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    if block_bytes:
        monkeypatch.setenv("FASTX_TPU_BLOCK_BYTES", str(block_bytes))
    out = {}
    for clean in (False, True):
        if clean:
            monkeypatch.setenv("FASTX_TPU_CLIPPER_CLEAN", "1")
        ref = run_cli_in_process("fastx_toolkit_tpu", "fastx_clipper", argv,
                                 data, tmp_path)
        got = run_cli_in_process("fastx_toolkit_tpu_torch", "fastx_clipper",
                                 argv, data, tmp_path)
        assert got == ref
        assert ref["rc"] == 0
        out[clean] = ref
    assert out[True]["stdout"] != out[False]["stdout"]

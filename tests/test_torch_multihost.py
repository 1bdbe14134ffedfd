"""The port's multi-process front end (``parallel/multihost.py``) in
process, against the JAX package's.

* record and line resync, at every byte offset of the tricky FASTQ, the
  numeric-quality FASTQ and the FASTA inputs of ``tests/test_multihost.py``
  (its generators; the JAX module's resync functions need no jax);
* shard ranges that partition the file, equal to the JAX module's;
* shard-only mode (``FASTX_TPU_NUM_SHARDS``/``_SHARD_ID``): the port's
  shards concatenate to the JAX package's single-process output for
  N = 2, 3, 4 (the quality trimmer, the line engine, the tabular
  uncollapser), file outputs take the ``.shard-`` suffix, and stdin is
  refused with the reference's text.
"""

import numpy as np
import pytest

from fastx_toolkit_tpu.parallel import multihost as ref_mh
from fastx_toolkit_tpu_torch.parallel import multihost as port_mh
from test_multihost import _synth_fasta, _synth_fastq
from test_torch_clipper_cli import run_cli_in_process

HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")


def _numeric_fastq():
    """tests/test_multihost.py::test_resync_fastq_numeric_quals's input."""
    recs, offsets, pos = [], [], 0
    rng = np.random.default_rng(11)
    for i in range(12):
        L = int(rng.integers(3, 9))
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))
        qual = b" ".join(b"%d" % int(x) for x in rng.integers(-10, 40, L))
        rec = b"@r%d\n%s\n+\n%s\n" % (i, seq, qual)
        offsets.append(pos)
        recs.append(rec)
        pos += len(rec)
    return b"".join(recs), offsets


INPUTS = {
    "fastq_tricky": (lambda: _synth_fastq(25), True),
    "fastq_numeric": (_numeric_fastq, True),
    "fasta": (lambda: _synth_fasta(25), False),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_resync_to_record_every_offset(name, tmp_path):
    make, is_fastq = INPUTS[name]
    data, offsets = make()
    p = tmp_path / "in.dat"
    p.write_bytes(data)
    size = len(data)
    with open(p, "rb") as f:
        for off in range(size + 1):
            got = port_mh.resync_to_record(f, off, size, is_fastq)
            want = ref_mh.resync_to_record(f, off, size, is_fastq)
            assert got == want == next((b for b in offsets if b >= off),
                                       size), off


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_resync_to_line_every_offset(name, tmp_path):
    data, _ = INPUTS[name][0]()
    p = tmp_path / "in.dat"
    p.write_bytes(data)
    size = len(data)
    starts = [0] + [i + 1 for i, c in enumerate(data) if c == 0x0A]
    with open(p, "rb") as f:
        for off in range(size + 1):
            got = port_mh.resync_to_line(f, off, size)
            want = ref_mh.resync_to_line(f, off, size)
            assert got == want == next((b for b in starts if b >= off),
                                       size), off


def test_shard_ranges_partition(tmp_path):
    """For any N, the record- and line-aligned shard ranges partition the
    file in order, equal to the JAX module's."""
    data, offsets = _synth_fastq(41, seed=19)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    size = len(data)
    with open(p, "rb") as f:
        for n in (1, 2, 3, 5, 8, 64):
            rec, lines = [], []
            for k in range(n):
                info = port_mh.ShardInfo(k, n, False)
                ref_info = ref_mh.ShardInfo(k, n, False)
                rec.append(port_mh.shard_byte_range(f, size, True, info))
                assert rec[-1] == ref_mh.shard_byte_range(f, size, True,
                                                          ref_info)
                lines.append(port_mh.shard_line_range(f, size, info))
                assert lines[-1] == ref_mh.shard_line_range(f, size,
                                                            ref_info)
            for cuts in (rec, lines):
                assert cuts[0][0] == 0 and cuts[-1][1] == size
                assert all(b == c for (_a, b), (c, _d) in zip(cuts, cuts[1:]))
                assert all(lo <= hi for lo, hi in cuts)
            assert all(lo in offsets or lo == size for lo, _ in rec)


def _shards(monkeypatch, tool, argv, n, cwd):
    """The port's ``tool`` once per shard of ``n`` in shard-only mode:
    the results of run_cli_in_process."""
    out = []
    for k in range(n):
        monkeypatch.setenv("FASTX_TPU_NUM_SHARDS", str(n))
        monkeypatch.setenv("FASTX_TPU_SHARD_ID", str(k))
        port_mh._reset_for_tests()
        try:
            out.append(run_cli_in_process("fastx_toolkit_tpu_torch", tool,
                                          argv, b"", cwd))
        finally:
            port_mh._reset_for_tests()
    monkeypatch.delenv("FASTX_TPU_NUM_SHARDS")
    monkeypatch.delenv("FASTX_TPU_SHARD_ID")
    return out


def _tabular(n=60, seed=5):
    rng = np.random.default_rng(seed)
    return b"".join(b"x%d\t%d-%d\tq\n" % (i, i, int(rng.integers(1, 4)))
                    for i in range(n))


# (tool, argv without the input, input bytes)
SHARDED = {
    "quality_trimmer": ("fastq_quality_trimmer", ["-t", "20", "-l", "5"],
                        lambda: _synth_fastq(57, seed=23, tricky=False)[0]),
    "pipeline_line_engine": ("fastx_pipeline", ["-Q", "33", HEADLINE],
                             lambda: _synth_fastq(57, seed=29,
                                                  tricky=False)[0]),
    "uncollapser_tabular": ("fastx_uncollapser", ["-c", "2"], _tabular),
}


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(SHARDED))
def test_shard_only_concat_equals_single(case, n, tmp_path, monkeypatch):
    """Shard-only mode: the port's shards, concatenated in order, equal
    the JAX package's single-process output (its classic loop for the
    pipeline, which its own tests hold byte-identical to its line
    engine; the port's shards run the line engine)."""
    tool, argv, make = SHARDED[case]
    p = tmp_path / "in.dat"
    p.write_bytes(make())
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FASTX_TPU_NO_LINEPATH", "1")
    argv = ["-i", str(p)] + argv
    single = run_cli_in_process("fastx_toolkit_tpu", tool, argv, b"", out)
    monkeypatch.delenv("FASTX_TPU_NO_LINEPATH")
    assert single["rc"] == 0 and single["stdout"]
    shards = _shards(monkeypatch, tool, argv, n, out)
    assert [r["rc"] for r in shards] == [0] * n
    assert b"".join(r["stdout"] for r in shards) == single["stdout"]
    assert sum(1 for r in shards if r["stdout"]) > 1


def test_shard_only_file_output_suffix(tmp_path, monkeypatch):
    data, _ = _synth_fastq(30, seed=5, tricky=False)
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    single = run_cli_in_process("fastx_toolkit_tpu", "fastq_quality_trimmer",
                                ["-t", "15", "-i", str(p)], b"", out)
    shards = _shards(monkeypatch, "fastq_quality_trimmer",
                     ["-t", "15", "-i", str(p), "-o", "o.fq"], 2, out)
    assert [r["rc"] for r in shards] == [0, 0]
    names = ["o.fq.shard-%05d-of-00002" % k for k in range(2)]
    assert [sorted(k for k in r if k.startswith("o.fq")) for r in shards] \
        == [[names[0]], [names[1]]]
    assert shards[0][names[0]] + shards[1][names[1]] == single["stdout"]


def test_shard_only_stdin_rejected(tmp_path, monkeypatch):
    """Both packages refuse a sharded read of stdin with the same text."""
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FASTX_TPU_NUM_SHARDS", "2")
    monkeypatch.setenv("FASTX_TPU_SHARD_ID", "0")
    res = {}
    for pkg, mh in (("fastx_toolkit_tpu", ref_mh),
                    ("fastx_toolkit_tpu_torch", port_mh)):
        mh._reset_for_tests()
        try:
            res[pkg] = run_cli_in_process(pkg, "fastq_quality_trimmer",
                                          ["-t", "20"], b"@a\nAC\n+\nII\n",
                                          tmp_path)
        finally:
            mh._reset_for_tests()
    ref, got = res["fastx_toolkit_tpu"], res["fastx_toolkit_tpu_torch"]
    assert got["rc"] == ref["rc"] == 1
    assert got["stderr"] == ref["stderr"]
    assert "seekable" in got["stderr"]


def test_shard_info_from_env(monkeypatch):
    """The five variables with the reference's meaning; no group in
    shard-only mode, identity merges outside a group."""
    for k in ("FASTX_TPU_COORDINATOR", "FASTX_TPU_NUM_SHARDS"):
        monkeypatch.delenv(k, raising=False)
    port_mh._reset_for_tests()
    assert port_mh.shard_info() == port_mh.ShardInfo(0, 1, False)
    monkeypatch.setenv("FASTX_TPU_NUM_SHARDS", "3")
    monkeypatch.setenv("FASTX_TPU_SHARD_ID", "2")
    port_mh._reset_for_tests()
    info = port_mh.shard_info()
    assert (info.process_id, info.num_processes, info.collective) == (2, 3,
                                                                      False)
    assert port_mh.shard_suffix("x.fq") == "x.fq.shard-00002-of-00003"
    assert port_mh.allsum(3, 4) == (3, 4)
    assert port_mh.global_record_offset(9) == 0
    monkeypatch.setenv("FASTX_TPU_SHARD_ID", "3")
    port_mh._reset_for_tests()
    with pytest.raises(ValueError, match="out of range"):
        port_mh.shard_info()
    port_mh._reset_for_tests()

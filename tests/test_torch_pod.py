"""The port's CLIs as two cooperating processes on a gloo process group
(``parallel/multihost.py``), against the JAX package's single-process
runs of the same tools, as ``tests/test_multihost.py::
test_two_process_tools_end_to_end`` does for the JAX package.

One spawn of two workers runs ``fastx_quality_stats`` (both engines),
``fastx_collapser -v`` (both engines, on a FASTA with duplicates across
the shard boundary), ``fastq_quality_trimmer -v``, ``fastx_uncollapser
-v`` (FASTA and tabular) and ``fastx_pipeline`` (the line engine, and
``-v``: the classic loop).  Merged outputs and the concatenated shards
must equal the JAX package's bytes, the ``-v`` reports must appear once,
from rank 0.  Then the launcher ``fastx_pod_torch --cpu -n 2`` runs one
tool.  Each group takes a free port from the OS.  torch's c10d logs a
line to stderr when it cannot resolve the client socket's hostname;
stderr is not compared, and only those lines are dropped before a
worker's stderr is shown.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_multihost import _synth_fastq
from test_torch_clipper_cli import run_cli_in_process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")
TIMEOUT = 240

WORKER = textwrap.dedent(
    """
    import importlib, json, os, sys
    from fastx_toolkit_tpu_torch.cli import common
    for tool, argv, env in json.load(open(sys.argv[1])):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        mod = importlib.import_module("fastx_toolkit_tpu_torch.cli.tools."
                                      + tool)
        sys.argv = [tool]
        st = common.run_tool_main(mod.tool_main, argv)
        sys.stdout.flush()
        assert st == 0, (tool, st)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    print("ALL-OK")
    """
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def without_c10d(text: str) -> str:
    return "".join(ln for ln in text.splitlines(keepends=True)
                   if "[c10d]" not in ln)


def _inputs(tmp_path):
    """The lane, the FASTA with duplicates straddling the shard boundary,
    its collapse (the JAX package's) and a tabular file."""
    rng = np.random.default_rng(77)
    fq, _ = _synth_fastq(401, seed=41, tricky=False)
    (tmp_path / "lane.fastq").write_bytes(fq)
    seqs = ["".join(rng.choice(list("ACGT"), 12)) for _ in range(40)]
    recs = ["%s\n%s\n" % (">r%d" % i, seqs[int(rng.integers(0, len(seqs)))])
            for i in range(300)]
    (tmp_path / "dups.fasta").write_bytes("".join(recs).encode())
    tab = b"".join(b"row%d\t%d-%d\tz\n" % (i, i, int(rng.integers(1, 5)))
                   for i in range(150))
    (tmp_path / "tab.txt").write_bytes(tab)


def _ref(tool, argv, tmp_path, env=None, monkeypatch=None):
    """The JAX package's single-process run, output to a file: (output
    bytes, report text)."""
    work = tmp_path / "ref"
    work.mkdir(exist_ok=True)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    try:
        r = run_cli_in_process("fastx_toolkit_tpu", tool,
                               ["-o", "out"] + argv, b"", work)
    finally:
        for k in env or {}:
            monkeypatch.delenv(k)
    assert r["rc"] == 0, r["stderr"]
    return r["out"], r["stdout"].decode()


@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_two_process_tools_end_to_end(tmp_path, monkeypatch):
    _inputs(tmp_path)
    p = {k: str(tmp_path / k) for k in ("lane.fastq", "dups.fasta",
                                         "tab.txt")}
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    col, _rep = _ref("fastx_collapser", ["-i", p["dups.fasta"]], tmp_path)
    (tmp_path / "collapsed.fasta").write_bytes(col)
    p["collapsed.fasta"] = str(tmp_path / "collapsed.fasta")
    out = tmp_path / "out"
    out.mkdir()

    # (name, tool, argv, env of the run, merged output or shards, report)
    cases = [
        ("stats_host", "fastx_quality_stats", ["-i", p["lane.fastq"]],
         {"FASTX_STATS_PATH": "host"}, True, False),
        ("stats_device", "fastx_quality_stats", ["-N", "-i", p["lane.fastq"]],
         {"FASTX_STATS_PATH": "device"}, True, False),
        ("col_host", "fastx_collapser", ["-v", "-i", p["dups.fasta"]],
         {"FASTX_COLLAPSE_PATH": "host"}, True, True),
        ("col_device", "fastx_collapser", ["-v", "-i", p["dups.fasta"]],
         {"FASTX_COLLAPSE_PATH": "device"}, True, True),
        ("trim", "fastq_quality_trimmer",
         ["-v", "-t", "20", "-l", "5", "-i", p["lane.fastq"]], {}, False,
         True),
        ("unc", "fastx_uncollapser", ["-v", "-i", p["collapsed.fasta"]], {},
         False, True),
        ("unc_tab", "fastx_uncollapser", ["-v", "-c", "2", "-i",
                                          p["tab.txt"]], {}, False, True),
        ("pipe_lines", "fastx_pipeline", ["-Q", "33", "-i", p["lane.fastq"],
                                          HEADLINE], {}, False, False),
        ("pipe_classic", "fastx_pipeline", ["-v", "-Q", "33", "-i",
                                            p["lane.fastq"], HEADLINE], {},
         False, True),
    ]
    cmds = [[tool, ["-o", str(out / name)] + argv, env]
            for name, tool, argv, env, _m, _r in cases]
    (tmp_path / "cmds.json").write_text(json.dumps(cmds))
    (tmp_path / "worker.py").write_text(WORKER)
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TORCH_DEVICE="cpu",
                   FASTX_TPU_COORDINATOR="127.0.0.1:%d" % port,
                   FASTX_TPU_NUM_PROCESSES="2",
                   FASTX_TPU_PROCESS_ID=str(rank))
        for k in ("FASTX_TPU_NUM_SHARDS", "FASTX_TPU_SHARD_ID"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp_path / "worker.py"),
             str(tmp_path / "cmds.json")], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        raw = [pr.communicate(timeout=TIMEOUT) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    outs = [o.decode() for o, _e in raw]
    for pr, o, (_o, e) in zip(procs, outs, raw):
        assert pr.returncode == 0, (o, without_c10d(e.decode()))
        assert o.endswith("ALL-OK\n")

    reports = []
    for name, tool, argv, env, merged, report in cases:
        ref_env = dict(env)
        if tool == "fastx_pipeline":
            # the JAX package's classic loop, which its own tests hold
            # byte-identical to its line engine
            ref_env["FASTX_TPU_NO_LINEPATH"] = "1"
        want, rep = _ref(tool, argv, tmp_path, ref_env, monkeypatch)
        if merged:
            got = (out / name).read_bytes()
            assert not (out / (name + ".shard-00000-of-00002")).exists()
        else:
            assert not (out / name).exists()
            got = b"".join((out / ("%s.shard-%05d-of-00002" % (name, k)))
                           .read_bytes() for k in range(2))
            assert all((out / ("%s.shard-%05d-of-00002" % (name, k)))
                       .stat().st_size for k in range(2))
        assert got == want, name
        assert bool(rep) == report, name
        reports.append(rep)
    # merged -v reports print once, from rank 0, with global counters
    assert outs[0] == "".join(reports) + "ALL-OK\n"
    assert outs[1] == "ALL-OK\n"


@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_pod_launcher_cpu(tmp_path, monkeypatch):
    """``fastx_pod_torch --cpu -n 2 -- fastq_quality_filter ...``: the
    shards concatenate to the JAX package's output, the report prints
    once."""
    fq, _ = _synth_fastq(301, seed=43, tricky=False)
    lane = tmp_path / "lane.fastq"
    lane.write_bytes(fq)
    argv = ["-q", "20", "-p", "50", "-v", "-i", str(lane)]
    want, rep = _ref("fastq_quality_filter", argv, tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("FASTX_TORCH_DEVICE", None)
    r = subprocess.run(
        [sys.executable, "-m", "fastx_toolkit_tpu_torch.cli.pod", "--cpu",
         "-n", "2", "--coordinator", "127.0.0.1:%d" % free_port(), "--",
         "fastq_quality_filter", "-o", str(tmp_path / "f.fq"), *argv],
        env=env, capture_output=True, timeout=TIMEOUT)
    assert r.returncode == 0, without_c10d(r.stderr.decode())
    assert r.stdout.decode() == rep and rep.startswith("Quality cut-off")
    assert b"".join((tmp_path / ("f.fq.shard-%05d-of-00002" % k)).read_bytes()
                    for k in range(2)) == want

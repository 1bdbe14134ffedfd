"""The port's host-only tools and plotters against the JAX package's, in
process, with exact equality, and the ``fastx-torch`` dispatcher against
``fastx-tpu``.

* ``seqalign_test``, ``fasta_formatter`` and ``fastq_quality_converter``
  run both packages' ``tool_main`` (``run_cli_in_process``): stdout,
  stderr, exit status and output files equal, on the galaxy rows (also
  against their goldens) and on seeded multi-line FASTA and FASTQ lanes:
  the formatter at ``-w 0/1/60``, ``-t``, ``-e``, with empty sequences and
  with ``FASTX_TPU_BLOCK_BYTES=7`` splitting lines and headers; the
  converter both ways with ``-v``, to stdout and to ``-o``.
* The three plotters (skipped without matplotlib, which draws them):
  the parsed data (``build_histogram``, ``_load``/``_percent_rows``, the
  boxplot's drawn columns), the error messages on FASTA, FASTQ and
  non-stats input, and the PNG bytes, equal when both draw with the same
  matplotlib.
"""

import gzip
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from fastx_toolkit_tpu_torch.core import native

from test_torch_clipper_cli import run_cli_in_process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(ROOT, "galaxy", "test-data")
PACKAGES = ("fastx_toolkit_tpu", "fastx_toolkit_tpu_torch")


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


def test_seqalign_test_equals_jax(tmp_path, monkeypatch):
    """Also the fixed text that chip_smoke.py holds the card's run to."""
    import chip_smoke

    ref = _compare("seqalign_test", [], b"", tmp_path, monkeypatch)
    assert ref["rc"] == 0
    assert ref["stdout"] == chip_smoke.SEQALIGN_TEXT.encode()


def _multiline_fasta(seed, n=40):
    """Records with sequences of 0-150 bases wrapped at random widths
    (some unwrapped, some empty), headers with spaces and dashes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(b">seq-%d some description %d\n" % (i, rng.integers(99)))
        seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                         int(rng.integers(0, 151)) if i % 7 else 0).tobytes()
        w = int(rng.integers(1, 80)) if i % 3 else max(len(seq), 1)
        for s in range(0, len(seq), w):
            out.append(seq[s:s + w] + b"\n")
    return b"".join(out)


@pytest.mark.parametrize("argv,block", [
    (["-w", "0"], None), (["-w", "1"], None), (["-w", "60"], None),
    (["-t"], None), (["-e"], None), (["-t", "-e", "-w", "5"], None),
    (["-w", "60", "-e"], "7"), (["-t"], "7"), (["-w", "3"], "1"),
    (["-w", "60", "-o", "out.fa"], None),
])
def test_fasta_formatter_equals_jax(argv, block, tmp_path, monkeypatch):
    data = _multiline_fasta(3)
    env = {"FASTX_TPU_BLOCK_BYTES": block} if block else None
    ref = _compare("fasta_formatter", argv, data, tmp_path, monkeypatch, env)
    assert ref["rc"] == 0 and (ref["stdout"] or ref["out.fa"])


@pytest.mark.parametrize("data", [
    b"", b">only\n", b">a\n>b\nAC\n\n\nGT\n>c\n", b"ACGT\n>x\nA",
    b">a\r\nAC\r\n",
])
@pytest.mark.parametrize("argv", [["-w", "2"], ["-t", "-e"]])
def test_fasta_formatter_edges_equal_jax(data, argv, tmp_path, monkeypatch):
    _compare("fasta_formatter", argv, data, tmp_path, monkeypatch,
             {"FASTX_TPU_BLOCK_BYTES": "3"})


@pytest.mark.parametrize("argv", [["-h"], ["-w", "-2"], ["-q"],
                                  ["-i", "missing.fa"]])
def test_fasta_formatter_usage_equals_jax(argv, tmp_path, monkeypatch):
    _compare("fasta_formatter", argv, b">a\nAC\n", tmp_path, monkeypatch)


@pytest.mark.parametrize("argv,inp,golden", [
    (["-w", "0"], "fasta_formatter1.fasta", "fasta_formatter1.out"),
    (["-w", "60"], "fasta_formatter1.fasta", "fasta_formatter2.out"),
    (["-n", "-Q", "64"], "fastq_qual_conv1.fastq", "fastq_qual_conv1.out"),
    (["-a", "-Q", "64"], "fastq_qual_conv1.fastq", "fastq_qual_conv1a.out"),
    (["-a", "-Q", "64"], "fastq_qual_conv2.fastq", "fastq_qual_conv2.out"),
    (["-n", "-Q", "64"], "fastq_qual_conv2.fastq", "fastq_qual_conv2n.out"),
])
def test_galaxy_rows_equal_jax_and_golden(argv, inp, golden, tmp_path,
                                          monkeypatch):
    tool = "fasta_formatter" if "formatter" in inp else \
        "fastq_quality_converter"
    ref = _compare(tool, argv, _fixture(inp), tmp_path, monkeypatch)
    assert ref["rc"] == 0 and ref["stdout"] == _fixture(golden)


@pytest.mark.skipif(native.LIB is None, reason="native codec unavailable")
@pytest.mark.parametrize("argv", [
    ["-Q", "33", "-n", "-v"], ["-Q", "33", "-a", "-v"],
    ["-Q", "33", "-n", "-v", "-o", "num.fq"],
    ["-Q", "64", "-v"],  # Phred+33 bytes read at 64: the codec's error
    ["-Q", "33", "-z", "-n", "-o", "num.fq.gz"], ["-x"],
])
def test_quality_converter_equals_jax(argv, tmp_path, monkeypatch):
    from fastx_toolkit_tpu_torch.synth import synth_lane_bytes

    data = synth_lane_bytes(300, 60, seed=9)
    ref = _compare("fastq_quality_converter", argv, data, tmp_path,
                   monkeypatch, {"FASTX_TPU_BLOCK_BYTES": "5000"})
    if argv[:2] == ["-Q", "33"] and argv[-1] == "-v":
        assert ref["stderr"] == "Input: 300 reads.\nOutput: 300 reads.\n"


def test_quality_converter_round_trip(tmp_path, monkeypatch):
    """-n then -a gives the input bytes back (as chip_smoke.py checks)."""
    from fastx_toolkit_tpu_torch.synth import synth_lane_bytes

    data = synth_lane_bytes(200, 50, seed=2)
    num = _compare("fastq_quality_converter", ["-Q", "33", "-n"], data,
                   tmp_path, monkeypatch)["stdout"]
    back = _compare("fastq_quality_converter", ["-Q", "33", "-a"], num,
                    tmp_path, monkeypatch)["stdout"]
    assert num != data and back == data


# ---------------------------------------------------------------------------
# the plotters
# ---------------------------------------------------------------------------


def _script(package, name):
    return importlib.import_module("%s.scripts.%s" % (package, name))


def _stats_file(tmp_path, argv):
    """fastx_quality_stats (the JAX package's) on the galaxy stats
    fixture, written to a file: the plotters' input."""
    from fastx_toolkit_tpu.cli.tools import fastx_quality_stats

    from util import run_tool

    r = run_tool(fastx_quality_stats, argv, _fixture("fastq_stats1.fastq"))
    path = tmp_path / ("stats%s.txt" % "".join(argv))
    path.write_bytes(r.stdout)
    return str(path)


def _bad_inputs(tmp_path):
    """FASTA, FASTQ, a non-stats table, an empty file, a missing file."""
    files = {"fa": b">r1\nACGTACGT\n>r2\nACGT\n",
             "fq": b"@r1\nACGT\n+\nIIII\n",
             "tab": b"a\tb\tc\n1\t2\t3\n", "empty": b""}
    paths = []
    for k, v in files.items():
        (tmp_path / k).write_bytes(v)
        paths.append(str(tmp_path / k))
    return paths + [str(tmp_path / "missing")]


def _run_script(fn, capsys):
    """``fn()`` as the script's ``main`` would run it: ``(status, stdout,
    stderr)``."""
    try:
        rc = fn()
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture
def mpl():
    return pytest.importorskip("matplotlib")


def _drawn(fn):
    """What ``fn`` hands matplotlib: every Axes.plot / add_patch / bar
    call's data, in call order."""
    import matplotlib.axes

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for meth in ("plot", "add_patch", "bar"):
            real = getattr(matplotlib.axes.Axes, meth)

            def wrap(self, *a, _real=real, _meth=meth, **k):
                if _meth == "add_patch":
                    p = a[0]
                    calls.append((_meth, p.get_xy(), p.get_width(),
                                  p.get_height()))
                else:
                    calls.append((_meth, repr(a), repr(sorted(k.items()))))
                return _real(self, *a, **k)
            mp.setattr(matplotlib.axes.Axes, meth, wrap)
        fn()
    return calls


def test_boxplot_equals_jax(mpl, tmp_path):
    stats = _stats_file(tmp_path, ["-Q", "64"])
    res = {}
    for pkg in PACKAGES:
        out = tmp_path / (pkg + ".png")
        mod = _script(pkg, "quality_boxplot")
        calls = _drawn(lambda: mod.main_io(
            ["-i", stats, "-t", "lane 1", "-o", str(out)]))
        res[pkg] = (calls, out.read_bytes())
    assert res[PACKAGES[0]] == res[PACKAGES[1]]
    assert res[PACKAGES[1]][1][:8] == b"\x89PNG\r\n\x1a\n"
    assert len(res[PACKAGES[1]][0]) == 6 * 36  # a patch and 5 lines a cycle


@pytest.mark.parametrize("line_graph", [False, True])
def test_nucleotide_distribution_equals_jax(mpl, line_graph, tmp_path):
    stats = _stats_file(tmp_path, ["-Q", "64", "-N"] if line_graph
                        else ["-Q", "64"])
    res = {}
    for pkg in PACKAGES:
        mod = _script(pkg, "nucleotide_distribution")
        lines = mod._load(stats, new_format=line_graph)
        rows = mod._percent_rows(lines, new_format=line_graph)
        out = tmp_path / (pkg + ".png")
        calls = _drawn(lambda: mod.main_io(
            ["-i", stats, "-o", str(out), "-t", "x"], line_graph=line_graph,
            prog="p"))
        res[pkg] = (lines, rows, calls, out.read_bytes())
    assert res[PACKAGES[0]] == res[PACKAGES[1]]
    assert len(res[PACKAGES[1]][1][0]) == 36


def test_clipping_histogram_equals_jax(mpl, tmp_path):
    fa = _fixture("fasta_collapser1.out")
    (tmp_path / "in.fa").write_bytes(fa)
    (tmp_path / "in.fa.gz").write_bytes(gzip.compress(fa, mtime=0))
    (tmp_path / "plain.fa").write_bytes(b">a\nACGT\n>b-x\nAC\n>c-3\nACGT\n"
                                        b">d-2-1\nA\n>e\n")
    res = {}
    for pkg in PACKAGES:
        mod = _script(pkg, "clipping_histogram")
        hists = []
        for name in ("in.fa", "plain.fa"):
            with open(tmp_path / name, "rb") as fh:
                hists.append(mod.build_histogram(fh))
        pngs = []
        for name in ("in.fa", "in.fa.gz"):
            out = tmp_path / (pkg + name + ".png")
            calls = _drawn(lambda: mod.main_io(
                [str(tmp_path / name), str(out)]))
            pngs.append((calls, out.read_bytes()))
        res[pkg] = (hists, pngs)
    assert res[PACKAGES[0]] == res[PACKAGES[1]]
    hists, pngs = res[PACKAGES[1]]
    assert hists[1] == {4: 4, 2: 1, 1: 1, 0: 1} and pngs[0] == pngs[1]


@pytest.mark.parametrize("script,call", [
    ("quality_boxplot", lambda m, p: m.main_io(["-i", p])),
    ("nucleotide_distribution",
     lambda m, p: m.main_io(["-i", p], line_graph=False, prog="p")),
    ("nucleotide_distribution",
     lambda m, p: m.main_io(["-i", p], line_graph=True, prog="p")),
    ("clipping_histogram", lambda m, p: m.main_io([p + ".missing", "o.png"])),
])
def test_plotter_messages_equal_jax(script, call, tmp_path, capsys):
    """The input checks need no matplotlib: FASTA, FASTQ, non-stats and
    missing input give the same message and status; so do usage and a
    bad argument."""
    for path in _bad_inputs(tmp_path):
        if script == "nucleotide_distribution" and path.endswith("missing"):
            continue  # both packages' script raises OSError there
        got = [_run_script(lambda: call(_script(pkg, script), path), capsys)
               for pkg in PACKAGES]
        assert got[0] == got[1], path
        assert got[1][0] == 1
    for argv in ([], ["-h"], ["-z"]):
        if script == "clipping_histogram" and argv:
            continue
        got = [_run_script(lambda: _script(pkg, script).main_io(
            argv, **({} if script != "nucleotide_distribution"
                     else {"line_graph": False, "prog": "p"})), capsys)
            for pkg in PACKAGES]
        assert got[0] == got[1], argv


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def test_dispatcher_lists_every_jax_tool():
    from fastx_toolkit_tpu.cli import main as jax_main
    from fastx_toolkit_tpu_torch.cli import main as torch_main

    assert len(torch_main.TOOLS) == 21
    assert {k: v.split(".", 1)[1] for k, v in torch_main.TOOLS.items()} == \
        {k: v.split(".", 1)[1] for k, v in jax_main.TOOLS.items()}
    for mod in torch_main.TOOLS.values():
        assert callable(importlib.import_module(mod).main)


def _dispatch(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TORCH_DEVICE="cpu")
    return subprocess.run(
        [sys.executable, "-c",
         "import sys\nsys.modules['jax'] = None\n"
         "from fastx_toolkit_tpu_torch.cli import main\nmain.main()\n",
         *args], capture_output=True, env=env, cwd=cwd, timeout=300)


def test_dispatcher_help_lists_21_tools(tmp_path):
    r = _dispatch(["--help"], tmp_path)
    assert r.returncode == 0
    names = [ln.strip() for ln in r.stdout.decode().splitlines()[3:]]
    assert len(names) == 21 and "fastx_barcode_splitter" in names


def test_dispatcher_line_graph_alias_runs_main_line(mpl, tmp_path):
    """``fastx_nucleotide_distribution_line_graph[.sh]`` runs the line
    graph: it takes the -N stats format, which the stacked graph
    refuses."""
    stats = _stats_file(tmp_path, ["-Q", "64", "-N"])
    line = _dispatch(["fastx_nucleotide_distribution_line_graph.sh", "-i",
                      stats, "-o", "l.png"], tmp_path)
    assert line.returncode == 0, line.stderr.decode()
    assert (tmp_path / "l.png").read_bytes()[:4] == b"\x89PNG"
    stacked = _dispatch(["fastx_nucleotide_distribution_graph", "-i", stats,
                         "-o", "s.png"], tmp_path)
    assert stacked.returncode == 1
    assert b"not a valid statistics report" in stacked.stderr

"""The PyTorch port imports and runs without jax and without anything of
the JAX package or the repository's ``bench`` module (a run with them
blocked, and a scan of the sources), CPU tensors take the plain path,
and a missing CUDA device is an error, never a quiet CPU fallback."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu_torch import synth
from fastx_toolkit_tpu_torch.device import resolve_device
from fastx_toolkit_tpu_torch.kernels import (
    align_cuda,
    align_unpacked_cuda,
    counts_cuda,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_py(code, stdin=b"", env_extra=None, args=(), cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TORCH_DEVICE="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code, *args], input=stdin,
                          capture_output=True, env=env, cwd=cwd, timeout=300)


def test_port_imports_without_jax():
    r = _run_py(
        "import sys\n"
        "import fastx_toolkit_tpu_torch\n"
        "import fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline\n"
        "import fastx_toolkit_tpu_torch.cli.tools.fastx_quality_stats\n"
        "import fastx_toolkit_tpu_torch.engine.lines\n"
        "import fastx_toolkit_tpu_torch.cli.main as m\n"
        "import importlib\n"
        "for t in m.TOOLS.values():\n"
        "    importlib.import_module(t)\n"
        "import fastx_toolkit_tpu_torch.ops.collapse\n"
        "import fastx_toolkit_tpu_torch.bench\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.strip() == b"ok"


def test_port_cli_runs_with_jax_unimportable():
    """Not only the imports: a whole CLI run must not reach jax (the
    machine with the card has none), so it runs with jax blocked."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(50):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60).tobytes()
        qual = (rng.integers(2, 41, 60) + 33).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
    r = _run_py(
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.argv[0] = 'fastx_pipeline'\n"
        "runpy.run_module('fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline',"
        " run_name='__main__')\n",
        stdin=b"".join(recs),
        args=("-Q", "33", "fastq_quality_trimmer -t 20 | "
              "fastx_clipper -a CTGTAGGCACCATCAAT -n | fastx_artifacts_filter"))
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.startswith(b"@r")


def test_port_runs_with_the_jax_package_and_bench_blocked():
    """The CLIs (the stats CLI on both engines), the port's bench and
    chip_smoke's helpers, with jax, the JAX package and bench made
    unimportable: nothing of them is loaded."""
    r = _run_py(
        "import io, os, sys\n"
        "for m in ('jax', 'fastx_toolkit_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "from fastx_toolkit_tpu_torch import bench as port_bench\n"
        "port_bench.N_READS, port_bench.CHUNK = 600, 256\n"
        "os.environ['FASTX_BENCH_ITERS'] = '1'\n"
        "from contextlib import redirect_stdout\n"
        "for argv in (['--config', '1'], ['--device', '--config', '3']):\n"
        "    with redirect_stdout(io.StringIO()):\n"
        "        assert port_bench.main(argv) == 0, argv\n"
        "from fastx_toolkit_tpu_torch import synth\n"
        "from fastx_toolkit_tpu_torch.cli.common import CliContext\n"
        "from fastx_toolkit_tpu_torch.cli.tools import fastx_clipper, "
        "fastx_pipeline\n"
        "data = synth.synth_small_rna_lane_bytes(60, 50, seed=1)\n"
        "for tool, argv in (\n"
        "        (fastx_clipper, ['-Q', '33', '-a', 'TGGAATTCTCGG', '-v']),\n"
        "        (fastx_pipeline, ['-Q', '33', 'fastq_masker -q 20 | "
        "fastx_clipper -a TGGAATTCTCGG -n']),\n"
        "        (fastx_pipeline, ['-v', '-Q', '33', 'fastx_clipper -a "
        "TGGAATTCTCGGGTGCCAAGGAGATCGGAAGAGC'])):\n"
        "    out, err = io.BytesIO(), io.StringIO()\n"
        "    ctx = CliContext(prog='t', stdin=io.BytesIO(data), stdout=out,\n"
        "                     stderr=err, stdout_text=io.StringIO())\n"
        "    assert tool.tool_main(ctx, argv) == 0, err.getvalue()\n"
        "    assert out.getvalue().startswith(b'@r'), argv\n"
        "from fastx_toolkit_tpu_torch.cli.tools import fastx_quality_stats\n"
        "import os\n"
        "for engine in ('host', 'device'):\n"
        "    os.environ['FASTX_STATS_PATH'] = engine\n"
        "    out, err = io.BytesIO(), io.StringIO()\n"
        "    ctx = CliContext(prog='t', stdin=io.BytesIO(data), stdout=out,\n"
        "                     stderr=err, stdout_text=io.StringIO())\n"
        "    assert fastx_quality_stats.tool_main(ctx, ['-N']) == 0, \\\n"
        "        err.getvalue()\n"
        "    assert out.getvalue().startswith(b'cycle\\tmax_count'), engine\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and (\n"
        "    m in ('jax', 'bench') or m.split('.')[0] == 'fastx_toolkit_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.strip() == b"ok"


def test_dispatcher_runs_with_the_jax_package_and_bench_blocked(tmp_path):
    """With jax, the JAX package and bench unimportable, every tool
    ``fastx-torch`` (``cli/main.py``) lists imports, the dispatcher runs
    the collapser on its device engine, a per-read tool on its classic
    path, the barcode splitter, the host-only tools, and refuses a tool
    neither package has with the reference's error and exit 1."""
    (tmp_path / "lane.fq").write_bytes(
        synth.synth_collapse_lane_bytes(400, pool=30, seed=2))
    lane, bcfile = synth.synth_barcode_lane_bytes(300, 40)
    (tmp_path / "bc.fq").write_bytes(lane)
    (tmp_path / "bc.txt").write_bytes(bcfile)
    r = _run_py(
        "import os, sys\n"
        "for m in ('jax', 'fastx_toolkit_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        "from fastx_toolkit_tpu_torch.cli import main\n"
        "for t in main.TOOLS.values():\n"
        "    importlib.import_module(t)\n"
        "codes = []\n"
        "for env, argv in (\n"
        "        (('FASTX_COLLAPSE_PATH', 'device'),\n"
        "         ['fastx_collapser', '-v', '-i', 'lane.fq', '-o', 'c.fa']),\n"
        "        (('FASTX_LINEPATH', 'off'),\n"
        "         ['fastq_quality_filter', '-Q', '33', '-q', '30', '-p', '50',\n"
        "          '-v', '-i', 'lane.fq', '-o', 'f.fq']),\n"
        "        (('X', ''), ['fastx_barcode_splitter.pl', '--bcfile',\n"
        "                     'bc.txt', '--bol', '--prefix', 'bc_']),\n"
        "        (('X', ''), ['seqalign_test']),\n"
        "        (('X', ''), ['fasta_formatter', '-i', 'c.fa', '-t', '-o',\n"
        "                     't.txt']),\n"
        "        (('X', ''), ['fastq_quality_converter', '-n', '-i',\n"
        "                     'lane.fq', '-o', 'n.fq']),\n"
        "        (('X', ''), ['fastx_no_such_tool'])):\n"
        "    os.environ[env[0]] = env[1]\n"
        "    sys.argv = ['fastx-torch'] + argv\n"
        "    sys.stdin = open('bc.fq')\n"
        "    try:\n"
        "        main.main()\n"
        "    except SystemExit as e:\n"
        "        codes.append(e.code)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and (\n"
        "    m in ('jax', 'bench') or m.split('.')[0] == 'fastx_toolkit_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('codes', codes)\n",
        cwd=tmp_path)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.splitlines()[-1] == b"codes [0, 0, 0, 0, 0, 0, 1]"
    assert b"fastx-torch: unknown tool 'fastx_no_such_tool'" in r.stderr
    assert b"total\t300\n" in r.stdout
    assert (tmp_path / "bc_BC01").read_bytes().startswith(b"@r")
    assert b"Score-Matrix" in r.stdout
    assert (tmp_path / "t.txt").read_bytes().startswith(b"1-")
    assert (tmp_path / "n.fq").read_bytes().count(b"\n") == 1600
    assert (tmp_path / "c.fa").read_bytes().startswith(b">1-")
    assert (tmp_path / "f.fq").read_bytes().startswith(b"@r")
    assert b"Input: 400 sequences (representing 400 reads)" in r.stdout


def _forbidden_imports(path):
    """Absolute imports of jax, the JAX package or bench in ``path``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "fastx_toolkit_tpu", "bench")]
    return bad


def test_port_sources_import_nothing_of_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT,
                                                "fastx_toolkit_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    pkg = os.path.join(ROOT, "fastx_toolkit_tpu_torch")
    assert {os.path.join(pkg, "probe.py"),
            os.path.join(pkg, "bench.py"),
            os.path.join(pkg, "kernels", "probe.py"),
            os.path.join(pkg, "kernels", "probe_cuda.py")} <= set(paths)
    found = {p: _forbidden_imports(p) for p in paths}
    assert not {p: b for p, b in found.items() if b}


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    before = (align_cuda.launches, align_cuda.wide_launches,
              counts_cuda.launches, align_unpacked_cuda.launches)
    b2w = torch.zeros((8, 4), dtype=torch.int32)
    nmw = torch.zeros((4, 4), dtype=torch.int32)
    lengths = torch.full((4,), 100, dtype=torch.int32)
    res = align_cuda.align_batch_packed(b2w, nmw, lengths, b"CTGTAGGCA", L=100,
                                        tie_flag=True)
    wide = align_cuda.align_batch_packed(b2w, nmw, lengths, b"CTGTA" * 8,
                                         L=100, tie_flag=True)
    worst, ncnt = counts_cuda.packed_counts(b2w, nmw, lengths)
    unpacked = align_unpacked_cuda.align_batch_unpacked(
        torch.full((4, 100), 65, dtype=torch.uint8), lengths, b"acgU",
        tie_flag=True)
    assert set(res) >= {"matches", "gaps", "tie_fragile"}
    assert set(wide) == set(unpacked) == set(res)
    assert worst.tolist() == [100] * 4 and ncnt.tolist() == [0] * 4
    assert (align_cuda.launches, align_cuda.wide_launches,
            counts_cuda.launches, align_unpacked_cuda.launches) == before


def test_resolve_device(monkeypatch):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the absent-CUDA error "
                    "cannot be shown here")
    monkeypatch.delenv("FASTX_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()  # the default is cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")

"""The stats reduction of the port's pipeline bodies and its mesh
functions (``parallel/mesh.py``) against the JAX package's, at
tolerance 0.

In process: ``pipeline_body``, ``packed_pipeline_body``,
``packed_decisions_pipeline`` and ``fused_pipeline`` with ``with_stats``
(the per-cycle counts included) against the JAX functions, the line
engine with ``with_stats`` doing what the JAX line engine does, and
``data_mesh`` refusing a mesh no group backs.  In two processes on gloo
(one spawn): every ``sharded_*`` at world size 2 against the JAX
single-device function on the whole batch (``ops/stats.accumulate``,
``pipeline_body`` and ``packed_pipeline_body`` with ``with_stats``,
``ops/collapse.collapse``, ``ops/transforms.barcode_match`` plus the
tally), and ``data_mesh`` refusing more ranks than the group has.
"""

import io
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.cli.tools._shared import BatchReader as RefReader
from fastx_toolkit_tpu.core import codec
from fastx_toolkit_tpu.engine import lines as ref_lines
from fastx_toolkit_tpu.engine import pipeline as ref_pipeline
from fastx_toolkit_tpu.ops import collapse as ref_collapse
from fastx_toolkit_tpu.ops import stats as ref_stats
from fastx_toolkit_tpu.ops import transforms as ref_transforms
from fastx_toolkit_tpu_torch.cli.tools._shared import BatchReader
from fastx_toolkit_tpu_torch.engine import lines as port_lines
from fastx_toolkit_tpu_torch.engine import pipeline as port_pipeline
from fastx_toolkit_tpu_torch.ops.collapse import pack_words
from fastx_toolkit_tpu_torch.parallel import mesh
from test_torch_barcode import _operands
from test_torch_lines import _lane
from test_torch_pipeline import CONFIGS, _chunk
from test_torch_pod import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RefConfig = ref_pipeline.PipelineConfig
STATS = ("count", "hist", "qsum", "qmin", "qmax")


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _eq(got, want, what):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what)


def _batch(seed, B=96, L=64):
    rng = np.random.default_rng(seed)
    bases, quals, lengths = _chunk(rng, B, L, True)
    counts = rng.integers(1, 5, B).astype(np.int32)
    return bases, quals, lengths.astype(np.int32), counts


@pytest.mark.parametrize("name", ["headline", "config2", "config4"])
def test_pipeline_body_with_stats(name):
    cfg = RefConfig(**{**CONFIGS[name].__dict__, "with_stats": True})
    b, q, l, c = _batch(1)  # noqa: E741
    want = ref_pipeline.pipeline_body(b, q, l, c, cfg)
    got = port_pipeline.pipeline_body(
        *_t(b, q, l), port_pipeline.config_from_reference(cfg),
        counts=torch.from_numpy(c))
    assert len(got) == 6
    for what, g, w in zip(("b", "q", "l", "keep", "count"),
                          got[:4] + got[5:], want):
        _eq(g, w, what)
    assert int(np.asarray(want[4]).sum()) > 0
    if name != "headline":
        return
    # fused_pipeline: the reference's single-device step, with and
    # without the reduction (zeros then)
    for stats in (True, False):
        rcfg = RefConfig(**{**cfg.__dict__, "with_stats": stats})
        want = ref_pipeline.fused_pipeline(rcfg)(b, q, l, c)
        got = port_pipeline.fused_pipeline(
            port_pipeline.config_from_reference(rcfg))(*_t(b, q, l, c))
        for what, g, w in zip(("b", "q", "l", "keep", "count"), got, want):
            _eq(g, w, "fused %s %s" % (stats, what))


@pytest.mark.parametrize("two_bit", [True, False])
def test_packed_pipeline_body_with_stats(two_bit):
    cfg = RefConfig(adapter=CONFIGS["headline"].adapter, with_stats=True)
    b, q, l, c = _batch(2, L=61)  # noqa: E741
    pack = ref_pipeline.pack_batch2 if two_bit else ref_pipeline.pack_batch
    packed, planes = pack(b, q, cfg)
    want = ref_pipeline.packed_pipeline_body(
        packed, planes, l, c, cfg, seq_len=61, two_bit=two_bit)
    pcfg = port_pipeline.config_from_reference(cfg)
    got = port_pipeline.packed_pipeline_body(
        *_t(packed, planes, l), pcfg, seq_len=61, two_bit=two_bit,
        counts=torch.from_numpy(c))
    for what, g, w in zip(("l", "keep", "count"), got[:2] + got[3:], want):
        _eq(g, w, what)
    if two_bit:
        # the decisions entry takes the unpacking body with the reduction
        want = ref_pipeline.packed_decisions_pipeline(cfg, seq_len=61,
                                                      two_bit=True)(
            packed, planes, l, c)
        got = port_pipeline.packed_decisions_pipeline(
            pcfg, packed, planes, l, has_n_plane=True, device="cpu",
            seq_len=61, counts=c)
        for what, g, w in zip(("l", "keep", "count"), got[:2] + got[3:],
                              want):
            _eq(g, w, "decisions " + what)
        with pytest.raises(TypeError, match="counts"):
            port_pipeline.packed_decisions_pipeline(
                pcfg, packed, planes, l, has_n_plane=True, device="cpu")


def _line_run(package, data, cfg):
    args = SimpleNamespace(input_filename="<test>", q_offset=33)
    out = []
    if package == "ref":
        reader = RefReader(None, args, filetype=codec.FASTQ_ONLY,
                           stream=io.BytesIO(data))
        n = ref_lines.stream_pipeline_lines(
            reader, cfg, out_fastq=True, q_offset=33, write=out.append,
            chunk_rows=16, engines=ref_lines.LineEngines(cfg))
    else:
        reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                             stream=io.BytesIO(data))
        n = port_lines.stream_pipeline_lines(
            reader, port_pipeline.config_from_reference(cfg), out_fastq=True,
            q_offset=33, write=out.append, device="cpu", chunk_rows=16)
    return n[:2], b"".join(out)


def test_line_engine_with_stats():
    """The JAX line engine with ``with_stats``: its packed step lacks the
    counts argument, so a clean FASTQ chunk raises TypeError; a classic
    chunk (numeric qualities) runs the unpacked step with the reduction
    and drops it.  The port does the same."""
    cfg = RefConfig(with_stats=True)
    clean = _lane(40, seed=24)
    with pytest.raises(TypeError):
        _line_run("ref", clean, cfg)
    with pytest.raises(TypeError):
        _line_run("port", clean, cfg)
    numeric = _lane(40, seed=23, numeric_at={5})
    want = _line_run("ref", numeric, cfg)
    assert _line_run("port", numeric, cfg) == want
    assert _line_run("port", numeric, RefConfig()) == want
    assert want[0][0] == 40


def test_data_mesh_needs_a_group(monkeypatch):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs"):
        mesh.data_mesh()


WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    from fastx_toolkit_tpu_torch.parallel import mesh
    rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    mesh.distributed_init(backend="gloo",
                          init_method="tcp://127.0.0.1:" + port,
                          world_size=2, rank=rank)
    m = mesh.data_mesh()
    try:
        mesh.data_mesh(3)
        raise SystemExit("data_mesh(3) did not raise at world size 2")
    except RuntimeError:
        pass
    d = dict(np.load(inp))
    res = {}
    b, q, l, c = mesh.shard_batch(m, d["bases"], d["quals"], d["lengths"],
                                  d["counts"])
    for k, t in zip(("count", "hist", "qsum", "qmin", "qmax"),
                    mesh.sharded_stats(m, b, q, l, c, is_fastq=True)):
        res["stats_" + k] = t.numpy()
    for k, t in zip(("b", "q", "l", "keep", "count"),
                    mesh.sharded_pipeline(m)(b, q, l, c)):
        res["pipe_" + k] = t.numpy()
    b2, planes = mesh.shard_batch(m, d["b2"], d["planes"])
    for k, t in zip(("l", "keep", "count"),
                    mesh.sharded_packed_pipeline(m, seq_len=int(d["L"]))(
                        b2, planes, l, c)):
        res["packed_" + k] = t.numpy()
    w, wc, wf = mesh.shard_batch(m, d["words"], d["wcounts"], d["wfirst"])
    for k, t in zip(("words", "counts", "first"),
                    mesh.sharded_collapse(m, w, wc, wf)):
        res["col_" + k] = t.numpy()
    bb, bl = mesh.shard_batch(m, d["bc_bases"], d["bc_lengths"])
    ident, tally = mesh.sharded_barcode_counts(
        m, bb, bl, torch.from_numpy(d["barcodes"]),
        torch.from_numpy(d["barcode_lens"]), torch.from_numpy(d["penalties"]),
        bol=True, barcodes_length=int(d["blen"]), mismatches=1,
        n_idents=int(d["n_idents"]), ident_of_barcode=d["ident_of"])
    res["bc_ident"], res["bc_tally"] = ident.numpy(), tally.numpy()
    np.savez(out, **res)
    torch.distributed.destroy_process_group()
    print("OK", rank)
    """
)


def test_sharded_world_2(tmp_path):
    b, q, l, c = _batch(3, B=128, L=64)  # noqa: E741
    cfg = RefConfig(with_stats=True)
    b2, planes = ref_pipeline.pack_batch2(b, q, cfg)
    rng = np.random.default_rng(4)
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (30, 20))
    col_bases = seqs[rng.integers(0, 30, 128)]
    words = pack_words(col_bases)
    wcounts = rng.integers(1, 4, 128).astype(np.int32)
    wfirst = np.arange(128, dtype=np.int32)
    ops = _operands(2, 128, 64, 24, 8, partial=1, short_frac=0.1,
                    n_frac=0.05)
    ident_of = (np.arange(len(ops[2])) // 2).astype(np.int32)
    n_idents = int(ident_of.max()) + 1
    inp = tmp_path / "in.npz"
    np.savez(inp, bases=b, quals=q, lengths=l, counts=c, b2=b2,
             planes=planes, L=64, words=words.view(np.int32),
             wcounts=wcounts, wfirst=wfirst, bc_bases=ops[0],
             bc_lengths=ops[1], barcodes=ops[2], barcode_lens=ops[3],
             penalties=ops[4], blen=8, n_idents=n_idents, ident_of=ident_of)
    (tmp_path / "worker.py").write_text(WORKER)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=ROOT, FASTX_TORCH_DEVICE="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), port, str(inp),
         str(tmp_path / ("out%d.npz" % r))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        raw = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, raw):
        assert p.returncode == 0, (o.decode(), e.decode())
    r = [dict(np.load(tmp_path / ("out%d.npz" % k))) for k in range(2)]
    cat = lambda k: np.concatenate([r[0][k], r[1][k]])  # noqa: E731

    def replicated(k, want, what):
        _eq(r[0][k], want, what)
        _eq(r[1][k], want, what + " (rank 1)")

    for k, w in zip(STATS, ref_stats.accumulate(b, q, l, c, is_fastq=True)):
        replicated("stats_" + k, w, "sharded_stats " + k)
    want = ref_pipeline.pipeline_body(b, q, l, c, cfg)
    for k, w in zip(("b", "q", "l", "keep"), want[:4]):
        _eq(cat("pipe_" + k), w, "sharded_pipeline " + k)
    replicated("pipe_count", want[4], "sharded_pipeline count")
    assert int(np.asarray(want[4]).sum()) > 0
    want = ref_pipeline.packed_pipeline_body(b2, planes, l, c, cfg,
                                             seq_len=64, two_bit=True)
    for k, w in zip(("l", "keep"), want[:2]):
        _eq(cat("packed_" + k), w, "sharded_packed_pipeline " + k)
    replicated("packed_count", want[2], "sharded_packed_pipeline count")
    perm, head, seg_id, seg_counts, seg_first = (
        np.asarray(a) for a in ref_collapse.collapse(words, wcounts, wfirst))
    replicated("col_words", words[perm].view(np.int32),
               "sharded_collapse words")
    replicated("col_counts", np.where(head, seg_counts[seg_id], 0),
               "sharded_collapse counts")
    replicated("col_first", np.where(head, seg_first[seg_id], 2 ** 31 - 1),
               "sharded_collapse first")
    idx, mm = (np.asarray(a) for a in ref_transforms.barcode_match(
        *ops, bol=True, barcodes_length=8))
    matched = (idx >= 0) & (mm <= 1)
    ident = np.where(matched, ident_of[np.maximum(idx, 0)], n_idents)
    _eq(cat("bc_ident"), np.where(matched, ident, -1),
        "sharded_barcode_counts ident")
    replicated("bc_tally", np.bincount(ident, minlength=n_idents + 1),
               "sharded_barcode_counts tally")
    assert 0 < int(matched.sum()) < 128

"""The port's barcode matcher and ``fastx_barcode_splitter`` against the
JAX package's, in process, with exact equality.

``barcode_match`` (``ops/transforms.py``) takes the same seeded operands
as the JAX function in both modes, with ties between barcodes, reads
shorter than the barcodes, partial-barcode penalties and N bytes; with no
barcode at all it reports every read unmatched, as the splitter does for
an empty barcode file.  The splitter runs the JAX script's ``main_io``
and the port's on the same bytes and barcode file: the sweep, tie and
error cases of ``test_differential_perl.py`` (whose inputs it imports),
an empty stdin, an unknown first byte, a truncated FASTQ record, a
missing final newline, an ``unmatched`` identifier in the barcode file
and a seeded inline-barcode lane; exit codes, stdout, stderr and every
output file must be equal.  Bytes are the data: there are no weights.
"""

import importlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastx_toolkit_tpu.ops import transforms as jax_transforms
from fastx_toolkit_tpu_torch import synth
from fastx_toolkit_tpu_torch.ops import transforms

from test_differential_perl import SWEEP, bcfile_bytes, make_barcodes, synth_input

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _operands(seed, B, L, K, blen, *, partial, short_frac, n_frac):
    """Reads over ACGT (N at ``n_frac``), every third carrying a barcode
    with a substitution now and then, lengths 0..L with ``short_frac`` of
    them below ``blen``; ``K`` barcodes with repeats (ties) and, with
    ``partial``, each barcode's trimmed variants after it (file order)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGTN[:4], (max(K, 1), blen))
    base[-1] = base[0]  # an exact repeat: every read ties on it
    rows, lens, pens = [], [], []
    for k in range(K):
        rows.append(base[k])
        lens.append(blen)
        pens.append(0)
        for p in range(1, partial + 1):
            rows.append(np.concatenate([base[k][p:], np.zeros(p, np.uint8)]))
            lens.append(blen - p)
            pens.append(p)
    bases = rng.choice(ACGTN[:4], (B, L))
    nm = rng.random((B, L)) < n_frac
    bases[nm] = ord("N")
    lengths = rng.integers(blen, L + 1, B)
    short = rng.random(B) < short_frac
    lengths[short] = rng.integers(0, blen, int(short.sum()))
    for b in range(0, B, 3):
        tag = base[rng.integers(0, max(K, 1))].copy()
        if rng.random() < 0.3:
            tag[rng.integers(0, blen)] = rng.choice(ACGTN)
        end = int(lengths[b])
        if rng.random() < 0.5:
            bases[b, :blen] = tag
        elif end >= blen:
            bases[b, end - blen:end] = tag
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    bc = (np.stack(rows) if rows else np.zeros((0, blen), np.uint8))
    return (bases.astype(np.uint8), lengths.astype(np.int32),
            bc.astype(np.uint8), np.array(lens, np.int32),
            np.array(pens, np.int32))


@pytest.mark.parametrize("bol", [True, False])
@pytest.mark.parametrize("seed,B,L,K,blen,partial,short_frac,n_frac", [
    (1, 300, 32, 6, 6, 0, 0.0, 0.0),
    (2, 500, 64, 24, 8, 2, 0.1, 0.05),
    (3, 257, 32, 3, 5, 1, 0.3, 0.2),
    (4, 1, 32, 1, 4, 0, 0.0, 0.0),
])
def test_barcode_match_equals_jax(bol, seed, B, L, K, blen, partial,
                                  short_frac, n_frac):
    ops = _operands(seed, B, L, K, blen, partial=partial,
                    short_frac=short_frac, n_frac=n_frac)
    want = jax_transforms.barcode_match(*(jnp.asarray(a) for a in ops),
                                        bol=bol, barcodes_length=blen)
    got = transforms.barcode_match(*(torch.from_numpy(a) for a in ops),
                                   bol=bol, barcodes_length=blen)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the last barcode repeats the first (and its variants the first's):
    # it ties with it on every read, so it never wins
    if K > 1:
        last = (K - 1) * (1 + partial)
        assert not (got[0].numpy() >= last).any()


def test_barcode_match_ties_take_the_first_in_file_order():
    """Equal counts on several barcodes: the first one in file order, and
    -1 with the start count where none beats ``barcodes_length``."""
    bc = np.frombuffer(b"AAAAA" b"AAATT" b"TTTTT" b"AAAAA" b"AATTA",
                       np.uint8).reshape(5, 5)
    reads = np.frombuffer(b"AAAAT" b"TTTTT" b"CCCCC" b"AAATA" b"AAAAA",
                          np.uint8).reshape(5, 5)
    reads = np.pad(reads, ((0, 0), (0, 27)))
    lens = np.full(5, 5, np.int32)
    blens = np.full(len(bc), 5, np.int32)
    pens = np.zeros(len(bc), np.int32)
    ops = (reads, lens, bc.copy(), blens, pens)
    got = transforms.barcode_match(*(torch.from_numpy(a) for a in ops),
                                   bol=True, barcodes_length=5)
    want = jax_transforms.barcode_match(*(jnp.asarray(a) for a in ops),
                                        bol=True, barcodes_length=5)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0][2].item() == -1 and got[1][2].item() == 5


def test_barcode_match_in_row_chunks(monkeypatch):
    """Rows split across passes give the rows' own results."""
    ops = _operands(6, 1000, 40, 12, 7, partial=1, short_frac=0.1,
                    n_frac=0.02)
    whole = transforms.barcode_match(*(torch.from_numpy(a) for a in ops),
                                     bol=False, barcodes_length=7)
    monkeypatch.setattr(transforms, "MATCH_ROWS", 97)
    parts = transforms.barcode_match(*(torch.from_numpy(a) for a in ops),
                                     bol=False, barcodes_length=7)
    for p, w in zip(parts, whole):
        assert torch.equal(p, w)


@pytest.mark.parametrize("B", [0, 5])
def test_barcode_match_without_barcodes_matches_nothing(B):
    """K = 0 (the JAX function raises on its empty reduction; the splitter
    never calls either with no barcode): every read unmatched."""
    bases = torch.zeros((B, 32), dtype=torch.uint8)
    idx, mm = transforms.barcode_match(
        bases, torch.full((B,), 10, dtype=torch.int32),
        torch.zeros((0, 6), dtype=torch.uint8),
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        bol=True, barcodes_length=6)
    assert idx.tolist() == [-1] * B and mm.tolist() == [6] * B


def run_splitter(package, workdir, bcfile, data, argv):
    """``package``'s splitter ``main_io`` in ``workdir`` as its ``main``
    would run it: ``(status, stdout bytes, stderr text, {file: bytes})``
    with the files under ``workdir/out``."""
    mod = importlib.import_module(package + ".scripts.barcode_splitter")
    errors = importlib.import_module(package + ".core.errors")
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)
    old = os.getcwd()
    out, err = io.StringIO(), io.StringIO()
    os.chdir(workdir)
    try:
        rc = mod.main_io(["--bcfile", bcfile, "--prefix", "out/", *argv],
                         io.BytesIO(data), out, err)
    except SystemExit as e:  # argument errors exit like the Perl's die
        rc = e.code if isinstance(e.code, int) else 1
    except errors.FastxError as e:  # what main() turns into stderr + status
        err.write(str(e))
        rc = e.status
    finally:
        os.chdir(old)
    outdir = os.path.join(workdir, "out")
    files = {}
    for f in sorted(os.listdir(outdir)):
        with open(os.path.join(outdir, f), "rb") as fh:
            files[f] = fh.read()
    return rc, out.getvalue().encode(), err.getvalue(), files


def compare(tmp_path, bcfile_payload, data, argv):
    bcfile = tmp_path / "bc.txt"
    bcfile.write_bytes(bcfile_payload)
    want = run_splitter("fastx_toolkit_tpu", str(tmp_path / "jax"),
                        str(bcfile), data, argv)
    got = run_splitter("fastx_toolkit_tpu_torch", str(tmp_path / "torch"),
                       str(bcfile), data, argv)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FASTX_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("bol,fastq,mm,exact,partial,suffix", SWEEP)
def test_splitter_sweep_equals_jax(tmp_path, bol, fastq, mm, exact, partial,
                                   suffix):
    seed = hash((bol, fastq, mm, exact, partial)) % 2**31
    bc_len = int(np.random.default_rng(seed).integers(5, 9))
    bcs = make_barcodes(seed + 1, 6, bc_len)
    data = synth_input(seed + 2, 400, bcs, bol=bol, fastq=fastq,
                       bc_len=bc_len)
    argv = ["--bol" if bol else "--eol", "--mismatches", str(mm)]
    if exact:
        argv.append("--exact")
    if partial:
        argv += ["--partial", str(partial)]
    if suffix:
        argv += ["--suffix", suffix[0]]
    rc, out, _err, files = compare(tmp_path, bcfile_bytes(bcs), data, argv)
    assert rc == 0 and out.endswith(b"total\t400\n") and files


def test_splitter_tie_cases_equal_jax(tmp_path):
    bcs = [b"AAAAAA", b"AAAATT", b"TTTTTT", b"AAATTA"]
    reads = [b"AAAATA" + b"CGCGCGCG", b"AAAAAT" + b"GGGGGGGG",
             b"TTTTAA" + b"ACACACAC", b"AATTTA" + b"CACACACA",
             b"AAAAAA" + b"TTTTTTTT"]
    data = b"".join(b">t%d\n%s\n" % (i, r) for i, r in enumerate(reads))
    rc, out, _err, files = compare(tmp_path, bcfile_bytes(bcs), data,
                                   ["--bol", "--mismatches", "2"])
    # t0 and t1 are one mismatch from BC01 and from BC02: the first wins
    assert rc == 0 and files["BC01"] == (b">t0\nAAAATACGCGCGCG\n"
                                         b">t1\nAAAAATGGGGGGGG\n"
                                         b">t4\nAAAAAATTTTTTTT\n")


@pytest.mark.parametrize("payload", [
    b"BC1\tAAAA\nBC2\tAAAAAA\n",  # differing lengths
    b"BC1\tAAXA\n",  # invalid character
    b"justoneword\n",
    b"",  # no barcode: every read unmatched
    b"BC-1\tACGTAC\n",  # a non-word identifier
    b"BC1\tA\n",  # no longer than the mismatches
    b"# only a comment\n",
    b"BC1\tACGTAC\nBC2\tTTGACA",  # no final newline
    b"unmatched\tACGTAC\nBC2\tTTGACA\n",  # the catch-all's own name
])
def test_splitter_barcode_files_equal_jax(tmp_path, payload):
    data = b">r0\nACGTACGT\n>r1\nTTGACAAA\n>r2\nGGGGGGGG\n"
    compare(tmp_path, payload, data, ["--bol"])


@pytest.mark.parametrize("data", [
    b"",  # empty stdin
    b"ACGT\n",  # unknown first byte
    b"@r0\nACGTACGT\n+\nIIIIIIII\n@r1\nACGTAC\n",  # truncated FASTQ record
    b"@r0\nACGTACGT\n+\nIIIIIIII\n@r1\nACGTAC\n+\n",  # ... at the qualities
    b"@r0\nACGTACGT\n+r0\nIIIIIIII\n@r1\nTTGACAGG\n+\nIIIIIIII",  # no final \n
    b">r0\nACGTACGT\n>r1\nTTGACA",  # FASTA without a final newline
    b">r0\nACGTACGT\n>r1\n",  # FASTA, empty last sequence
    b">r0\n",  # a name with no sequence line
])
def test_splitter_inputs_equal_jax(tmp_path, data):
    compare(tmp_path, b"BC1\tACGTAC\nBC2\tTTGACA\n", data,
            ["--eol", "--mismatches", "1", "--partial", "1"])


@pytest.mark.parametrize("argv", [
    [], ["--help"], ["--bol", "--eol"], ["--bol", "--partial", "2"],
    ["--bol", "--mismatches", "-1"], ["--bol", "--bogus"],
    ["--bol", "--suffix"], ["--eol", "--quiet"],
])
def test_splitter_arguments_equal_jax(tmp_path, argv):
    compare(tmp_path, b"BC1\tACGTAC\n", b">r0\nACGTACGT\n", argv)


@pytest.mark.parametrize("bol,argv", [
    (True, ["--bol", "--mismatches", "1", "--suffix", ".fq"]),
    (False, ["--eol", "--partial", "1", "--mismatches", "1"]),
])
def test_splitter_lane_equals_jax_and_matches_on_the_device(
        tmp_path, monkeypatch, bol, argv):
    """A seeded inline-barcode lane: equal to the JAX script, and the
    matcher called once, on the device FASTX_TORCH_DEVICE names."""
    lane, bcfile = synth.synth_barcode_lane_bytes(3000, 60, bol=bol)
    seen = []
    real = transforms.barcode_match
    monkeypatch.setattr(transforms, "barcode_match",
                        lambda *a, **k: seen.append(a[0].device.type)
                        or real(*a, **k))
    rc, out, _err, files = compare(tmp_path, bcfile, lane, argv)
    assert rc == 0 and seen == ["cpu"]
    assert len(files) == 25 and out.endswith(b"total\t3000\n")
    unmatched = int(out.split(b"unmatched\t")[1].split(b"\t")[0])
    assert 0.03 * 3000 < unmatched < 0.12 * 3000


@pytest.mark.parametrize("argv", [["--bol", "--mismatches", "2"],
                                  ["--eol", "--mismatches", "1",
                                   "--partial", "1"]])
def test_splitter_galaxy_fixture_equals_jax(tmp_path, argv):
    """The galaxy wrapper's fixture and options."""
    td = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "galaxy", "test-data")
    with open(os.path.join(td, "fastx_barcode_splitter1.txt"), "rb") as fh:
        bcfile = fh.read()
    with open(os.path.join(td, "fastx_barcode_splitter1.fastq"), "rb") as fh:
        data = fh.read()
    rc, out, _err, files = compare(tmp_path, bcfile, data, argv)
    assert rc == 0 and sorted(files) == ["BC1", "BC2", "BC3", "unmatched"]


@pytest.mark.parametrize("bol,partial", [(True, 0), (False, 1)])
def test_smoke_reference_equals_jax(tmp_path, bol, partial):
    """``chip_smoke.barcode_reference``, the numpy reference that path (g)
    holds the card's run to, gives the JAX script's files and summary."""
    import chip_smoke

    lane, bcfile = synth.synth_barcode_lane_bytes(4000, 50, bol=bol)
    argv = ["--bol" if bol else "--eol", "--mismatches", "1",
            "--suffix", ".fq"] + (["--partial", str(partial)] if partial
                                  else [])
    (tmp_path / "bc.txt").write_bytes(bcfile)
    rc, out, _err, files = run_splitter(
        "fastx_toolkit_tpu", str(tmp_path), str(tmp_path / "bc.txt"), lane,
        argv)
    want_files, summary = chip_smoke.barcode_reference(
        lane, bcfile, bol=bol, partial=partial, mismatches=1, prefix="out/",
        suffix=".fq")
    assert rc == 0 and out.decode() == summary
    assert {"out/" + k: v for k, v in files.items()} == want_files

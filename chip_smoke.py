#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port (``fastx_toolkit_tpu_torch``) and nothing of jax:

1. device  — CUDA must be available; prints the card's name and power
   limit (``nvidia-smi --query-gpu=name,power.limit``);
2. build   — compiles the CUDA kernels from ``fastx_toolkit_tpu_torch/csrc``
   with nvcc and prints the build seconds and the compiler's register /
   spill report;
3. kernels — K1 (packed adapter DP) and K2 (packed counts) against their
   plain torch versions on the card, on the first 262,144 reads of the
   headline lane packed as the engine packs them (flags on), on the
   no-N-plane shortcut, and on adversarial batches at H=31 and L=511:
   every output field must be equal (tolerance 0: integer results);
4. main    — the headline chain through the ``fastx_pipeline`` CLI (in
   process, stdin/stdout in memory) on the seeded 1,000,000 x 100 bp
   lane, the kernels' launch counters set to 0 just before; the output
   bytes must equal a host reference rendered from float32 host
   decisions (``engine/hostfix``) over all reads, which never touches the
   kernels; then the same through ``stream_pipeline_lines``;
5. times   — end-to-end reads/s (median of 3 runs after a warm-up) and
   the device time of K1 and K2 beside their plain versions;
6. prints the kernels' JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero.  Without CUDA it exits 2 and prints no
result.
"""

import io
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

import bench
from fastx_toolkit_tpu_torch.cli.common import CliContext
from fastx_toolkit_tpu_torch.cli.tools import fastx_pipeline
from fastx_toolkit_tpu_torch.cli.tools._shared import BatchReader
from fastx_toolkit_tpu_torch.core import codec, native
from fastx_toolkit_tpu_torch.engine import hostfix
from fastx_toolkit_tpu_torch.engine.lines import LineEngines, stream_pipeline_lines
from fastx_toolkit_tpu_torch.engine.pipeline import (
    PipelineConfig,
    _thresholds,
    _words_T,
    packed_quality_stage,
)
from fastx_toolkit_tpu_torch.kernels import _build, align_cuda, counts_cuda
from fastx_toolkit_tpu_torch.ops.clipper import adapter_cutoff_index, clip_cut_lengths

N_READS = 1_000_000
READ_LEN = 100
CHUNK = 262_144
SEED = 42
HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")
FIELDS = ("matches", "mismatches", "gaps", "neutral", "query_start",
          "query_end", "target_start", "target_end", "tie_fragile")


def fail(msg):
    print("FAIL: " + msg, flush=True)
    sys.exit(1)


def record_cut(data: bytes, n_records: int) -> int:
    """Byte offset just past the first ``n_records`` FASTQ records."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
    return int(nl[4 * n_records - 1]) + 1


def pack_lane_chunk(fr, cfg, device):
    """The engine's packing of one N-free chunk: 2-bit bases and the
    threshold planes, width rounded up to a multiple of 8, on ``device``."""
    W = -(-int(fr.seq_lens.max()) // 8) * 8
    B = len(fr)
    thr = _thresholds(cfg)
    b2 = np.zeros((B, (W + 3) // 4), np.uint8)
    planes = np.zeros((B, len(thr), (W + 7) // 8), np.uint8)
    native.pack2_lines(fr.buf, fr.seq_starts, fr.qual_starts, fr.seq_lens,
                       W, 33, thr, False, b2_out=b2, planes_out=planes)
    lengths = fr.seq_lens.astype(np.int16)
    return (torch.from_numpy(b2).to(device), torch.from_numpy(planes).to(device),
            torch.from_numpy(lengths).to(device), int(fr.seq_lens.max()))


def adversarial(rng, B, L, adapter, n_frac, device):
    """Random reads (N fraction ``n_frac``) with noisy adapters spiked in
    and random lengths 0..L, as packed words (b2w, nmw) on ``device``."""
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    p = [(1 - n_frac) / 4] * 4 + [n_frac]
    bases = rng.choice(alpha, size=(B, L), p=p)
    pos = rng.integers(0, max(1, L - len(adapter)), B)
    ad = np.frombuffer(adapter, np.uint8)
    for j in range(len(ad)):
        m = (rng.random(B) < 0.4) & (pos + j < L)
        col = np.where(rng.random(B) < 0.9, ad[j], rng.choice(alpha[:4], B))
        bases[m, (pos + j)[m]] = col[m]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = ord("A")
    quals = np.full((B, L), 30, np.int8)
    b2, planes = native.pack2(np.ascontiguousarray(bases), quals, (), True)
    L32 = -(-L // 32) * 32
    b2w = _words_T(torch.from_numpy(b2).to(device), L32 // 4)
    nmw = _words_T(torch.from_numpy(np.ascontiguousarray(planes[:, 0])).to(device),
                   L32 // 8)
    return b2w, nmw, torch.from_numpy(lengths).to(device)


def compare(name, got, want, fields):
    err = 0
    for k in fields:
        d = (got[k].long() - want[k].long()).abs().max().item() if len(got[k]) else 0
        err = max(err, d)
        if d:
            bad = torch.nonzero(got[k] != want[k])[:5].flatten().tolist()
            fail("%s: field %s differs from the plain version (rows %s)"
                 % (name, k, bad))
    print("  %-34s equal on %d fields, %d rows, max_abs_err=%d"
          % (name, len(fields), len(got[fields[0]]), err), flush=True)
    return err


def cuda_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls (after one
    warm-up call), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run_main_path(data, cfg, engines, arena):
    args = SimpleNamespace(input_filename="<lane>", q_offset=33)
    reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                         stream=io.BytesIO(data))
    return stream_pipeline_lines(reader, cfg, out_fastq=True, q_offset=33,
                                 write=None, device=engines.device,
                                 arena=arena, chunk_rows=CHUNK,
                                 engines=engines)


def host_reference(data, cfg):
    """The lane's output rendered from float32 host decisions over every
    read (numpy and the native float32 clipper; no kernel runs)."""
    out = []
    n_kept = 0
    pos = 0
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
    n_rec = len(nl) // 4
    for r0 in range(0, n_rec, CHUNK):
        r1 = min(n_rec, r0 + CHUNK)
        end = int(nl[4 * r1 - 1]) + 1
        fr = codec.frame_fastq_fast(data[pos:end])
        pos = end
        buf = np.frombuffer(fr.buf, np.uint8)
        lens = np.ascontiguousarray(fr.seq_lens)
        lm = int(lens.max())
        b = native.gather_rows(buf, fr.seq_starts, lens, lm)
        q = native.gather_rows(buf, fr.qual_starts, lens, lm).astype(np.int16) - 33
        l, keep = hostfix.host_decide(cfg, b, q, lens.astype(np.int32))
        n_kept += int(keep.sum())
        out.append(native.render_lines(
            fr.buf, fr.name_starts, fr.name_lens, fr.seq_starts,
            fr.qual_starts, fr.name2_starts, fr.name2_lens, l,
            keep.astype(np.uint8), out_fastq=True, q_offset=33,
            mask_thr=cfg.mask_q))
    return b"".join(out), n_kept


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("[1 device] %s | nvidia-smi: %s | torch %s, CUDA %s"
          % (name, smi, torch.__version__, torch.version.cuda), flush=True)
    card = "%s, %s" % (name, smi.split(",")[-1].strip())

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print("[2 build] %.1f s -> %s" % (time.perf_counter() - t0,
                                      os.path.relpath(so)), flush=True)
    with open(os.path.join(os.path.dirname(so), "build.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.rstrip(), flush=True)

    # 3. kernels vs plain, on the card
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    data = bench.synth_lane_bytes(N_READS, READ_LEN, seed=SEED)
    print("[3 kernels] lane: %d reads x %d bp, %d bytes (%.1f s)"
          % (N_READS, READ_LEN, len(data), time.perf_counter() - t0),
          flush=True)
    fr = codec.frame_fastq_fast(data[:record_cut(data, CHUNK)])
    b2, planes, lengths, seq_len = pack_lane_chunk(fr, cfg, dev)
    l, _keep, b2w, nmw = packed_quality_stage(b2, planes, lengths, cfg,
                                              has_n_plane=False)
    adapter = cfg.adapter
    errs = {"align_packed12": 0, "packed_counts": 0}

    def k1_check(label, b2w_, nmw_, l_, adapter_, L_):
        got = align_cuda.align_batch_packed(b2w_, nmw_, l_, adapter_, L=L_,
                                            tie_flag=True)
        want = align_cuda.align_batch_packed_plain(b2w_, nmw_, l_, adapter_,
                                                   L=L_, tie_flag=True)
        torch.cuda.synchronize()
        errs["align_packed12"] = max(errs["align_packed12"],
                                     compare(label, got, want, FIELDS))
        return got

    def k2_check(label, b2w_, nmw_, l_):
        got = dict(zip(("worst", "ncnt"), counts_cuda.packed_counts(b2w_, nmw_, l_)))
        want = dict(zip(("worst", "ncnt"),
                        counts_cuda.packed_counts_plain(b2w_, nmw_, l_)))
        torch.cuda.synchronize()
        errs["packed_counts"] = max(errs["packed_counts"],
                                    compare(label, got, want, ("worst", "ncnt")))

    res = k1_check("K1 lane 262144 flagged", b2w, nmw, l, adapter, seq_len)
    n_flag = int(res["tie_fragile"].sum())
    print("  (lane chunk: %d reads flagged tie_fragile)" % n_flag, flush=True)
    k1_check("K1 lane 262144 nmw=None shortcut", b2w, None, l, adapter,
             seq_len)
    new_len = clip_cut_lengths(adapter_cutoff_index(res, l), l)
    k2_check("K2 lane 262144 post-clip", b2w, nmw, new_len)
    k2_check("K2 lane 262144 no N plane", b2w, None, new_len)
    rng = np.random.default_rng(SEED)
    h31 = b"CCTTAAGGCCTTAAGGCCTTAAGGCCTTAAG"
    a_b2w, a_nmw, a_l = adversarial(rng, 8192, 100, h31, 0.05, dev)
    k1_check("K1 adversarial H=31 L=100", a_b2w, a_nmw, a_l, h31, 100)
    k2_check("K2 adversarial L=100", a_b2w, a_nmw, a_l)
    nad = b"CTGNAGGCANCATCAAT"
    k1_check("K1 adversarial N-adapter L=100", a_b2w, a_nmw, a_l, nad, 100)
    a_b2w, a_nmw, a_l = adversarial(rng, 2048, 511, adapter, 0.03, dev)
    k1_check("K1 adversarial H=17 L=511", a_b2w, a_nmw, a_l, adapter, 511)
    k2_check("K2 adversarial L=511", a_b2w, a_nmw, a_l)

    # 4. main path: the fastx_pipeline CLI on the lane, on the card
    stdout = io.BytesIO()
    ctx = CliContext(prog="fastx_pipeline", stdin=io.BytesIO(data),
                     stdout=stdout, stderr=sys.stderr, stdout_text=sys.stdout)
    align_cuda.launches = 0
    counts_cuda.launches = 0
    t0 = time.perf_counter()
    status = fastx_pipeline.tool_main(ctx, ["-Q", "33", HEADLINE])
    cli_s = time.perf_counter() - t0
    launches = {"align_packed12": align_cuda.launches,
                "packed_counts": counts_cuda.launches}
    got = stdout.getvalue()
    t0 = time.perf_counter()
    want, want_kept = host_reference(data, cfg)
    ref_s = time.perf_counter() - t0
    print("[4 main] fastx_pipeline '%s': status %d, %d reads in, %d out, %d "
          "bytes out (%.2f s); host reference %d reads out, %d bytes (%.1f "
          "s); launches %s" % (HEADLINE, status, N_READS, got.count(b"\n") // 4,
                               len(got), cli_s, want_kept, len(want), ref_s,
                               launches), flush=True)
    if status != 0:
        fail("fastx_pipeline exited with status %d" % status)
    if got != want:
        diff = next((i for i in range(min(len(got), len(want)))
                     if got[i] != want[i]), min(len(got), len(want)))
        fail("main path output differs from the host reference at byte %d"
             % diff)
    print("  output bytes equal the host reference", flush=True)
    for k, v in launches.items():
        if v <= 0:
            fail("kernel %s was not launched by the main path" % k)
    # the same chain through the library entry point (as bench.py drives
    # it), which reports the reads re-decided on the host; also the
    # warm-up of the timed runs below
    engines = LineEngines(cfg, dev)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    n_in, n_out, nbytes = run_main_path(data, cfg, engines, arena)
    print("  stream_pipeline_lines: %d reads in, %d out, %d flagged "
          "tie_fragile and re-decided on the host" % (n_in, n_out,
                                                       engines.fragile_rows),
          flush=True)
    if (n_in, n_out) != (N_READS, want_kept) or bytes(arena[:nbytes]) != want:
        fail("stream_pipeline_lines output differs from the host reference")

    # 5. times
    times = []
    for it in range(3):
        t0 = time.perf_counter()
        _n, _o, nb = run_main_path(data, cfg, engines, arena)
        times.append(time.perf_counter() - t0)
        if bytes(arena[:nb]) != want:
            fail("timed run %d output differs" % it)
    med = sorted(times)[1]
    print("[5 times] end to end: %.0f reads/s, %.1f MB/s in (median of 3 "
          "after a warm-up; runs %s s) on %s"
          % (N_READS / med, len(data) / med / 1e6,
             ", ".join("%.3f" % t for t in times), card), flush=True)
    ms = {
        "align_packed12": cuda_ms(lambda: align_cuda.align_batch_packed(
            b2w, nmw, l, adapter, L=seq_len, tie_flag=True), 10),
        "packed_counts": cuda_ms(lambda: counts_cuda.packed_counts(
            b2w, nmw, new_len), 20),
    }
    plain_ms = {
        "align_packed12": cuda_ms(lambda: align_cuda.align_batch_packed_plain(
            b2w, nmw, l, adapter, L=seq_len, tie_flag=True), 2),
        "packed_counts": cuda_ms(lambda: counts_cuda.packed_counts_plain(
            b2w, nmw, new_len), 5),
    }
    for k in ms:
        print("  %-15s %.3f ms (plain torch %.3f ms) per 262144 reads x %d "
              "bp on %s" % (k, ms[k], plain_ms[k], seq_len, card), flush=True)

    # 6. kernels
    meta = {
        "align_packed12": ("fastx_toolkit_tpu_torch/csrc/align_packed12.cu",
                           "fastx_toolkit_tpu/kernels/align_pallas.py:403"),
        "packed_counts": ("fastx_toolkit_tpu_torch/csrc/packed_counts.cu",
                          "fastx_toolkit_tpu/kernels/counts_pallas.py:31"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": meta[k][0],
         "replaces": meta[k][1], "launches": launches[k],
         "max_abs_err": errs[k], "ms": ms[k], "plain_ms": plain_ms[k]}
        for k in ms]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port (``fastx_toolkit_tpu_torch``) and nothing of jax or
of the JAX package:

1. device  — CUDA must be available; prints the card's name and power
   limit (``nvidia-smi --query-gpu=name,power.limit``);
2. build   — compiles the CUDA kernels from ``fastx_toolkit_tpu_torch/csrc``
   with nvcc, the paths' library and the probe's at once, and prints the
   build seconds, the compiler's register / spill report, the SASS
   instructions a DP cell of both lane-group kernels, K1/K3's and K4's,
   and a base of K5's and K2's kernels (their hot loops in ``cuobjdump
   --dump-sass``), and holds K4's (G, K) pick and gate and K5's route and
   one-tile plan in the library equal to the wrapper's;
3. kernels — every kernel against its plain torch version on the card,
   every output field equal (tolerance 0: integer results), and each
   adapter-DP and histogram call on the launch counter of its route:
   K1 (packed adapter DP, on K3's lane-group kernel) and K2 (packed
   counts) on the first 262,144 reads of the headline lane, on the
   no-N-plane shortcut and on adversarial batches at H=31 and L=511; K3
   (wide packed DP) on the first 262,144 reads of a 1M x 150 bp lane
   spiked with the 33-base TruSeq adapter, on its no-N-plane shortcut and
   at H=72, L=600, and at each edge of its lane groups (9 adapter rows a
   lane): H = 1, 9, 10, 18, 19, 31, 32, 33, 36, 37, 64, 72 on 1,001 reads
   (L = 600 below H = 32, where K1's gate takes L <= 511, else 150) with
   lengths 0, 1, below the lane count and L among them, and 256 reads of
   L = 4,000, each with and without the N plane and the flags; K4
   (unpacked DP) on the first 262,144 reads of the 1M x 50 bp small-RNA
   lane, on its legacy-effective bases, at H=99 with lowercase and U
   bytes (L=300), at B=1 and B=300, and at each edge of its (G, K)
   picks (H = 1, 8, 9, 16, 17, 18, 21, 22, 32-35, 64, 65, 72, 73, 99, 127
   on 1,001 reads of L = 150 with lengths 0, 1, below the lane count and
   L among them, in the table variant and from H = 8 the compare
   variant, with and without the flags), and on its one-thread-per-read
   route beyond the gate (H = 128 on 4,096 reads of L = 200, and H = 21
   on 64 reads of width 32,750 whose lengths stay below 1,000, held
   against the plain version on their first 1,000 columns: columns at or
   past a read's length never reach its result); K5
   (quality-stats histogram) on the first 262,144 reads of the headline
   lane (L=128) and of the TruSeq lane (L=160), on a batch of one quality
   value, on bytes outside ACGTN with qualities below -15 and above 93,
   at B=1, B=300 and L=301 (the tiled kernel, on its own counter), at
   each edge of its routes and tiles (L = 1, 31-33, 64, 65, 128, 160 and
   301 on 5,001 reads with lengths 0, 1, L, past L and negative among
   them, in both modes and with the quals at an odd address), and on more
   reads than its resident blocks may tally into 16-bit counters, all in
   one bin; K5b (its 2-bit mode) on the headline reads; K2 also at its
   word edges (lengths 0, 1, 15-17, 31-33, the words' end and past it, N
   bits on word edges, at L = 64, 150 and 600, with and without the N
   plane);
   in phase 4, K4 again on the inputs of every launch that paths (a) and
   (c) made, K3 on those of path (b) and K5b and K5 on those of path (d)
   (kept as device copies during the run), so each is held
   against its plain version at each shape a path gives it; P (the
   plane-op probe, ``csrc/plane_probe.cu``) in every variant (``reg`` and
   ``smem``, the four TPU cases, DPX for the dependent two) at every shape
   path (p) times (B = 262,144 at H = 17, 21, 33, 72 with its shared
   memory a block, and the TPU's shape) and at the TPU's H with B =
   262,144, K = 32, U = 256;
4. paths   — at full width, each run with the kernels' launch counters
   set to 0 just before, each output held byte for byte against a host
   reference that never touches a kernel (numpy and the native float32
   clipper):
   main  the headline chain through the ``fastx_pipeline`` CLI on the
         seeded 1,000,000 x 100 bp lane (line engine: K1, K2), then the
         same through ``stream_pipeline_lines``;
   (a)   ``fastx_clipper -Q 33 -a TGGAATTCTCGGGTGCCAAGG -l 15 -c -v`` on
         the 1M x 50 bp small-RNA lane (K4, with the legacy emulation);
   (b)   ``fastx_pipeline -Q 33`` on the headline chain with the TruSeq
         adapter, on the 1M x 150 bp lane (K3 and K2; K1 never);
   (c)   ``fastx_pipeline -v -Q 33`` on the headline chain and lane: the
         classic per-batch loop (K4), its ``-v`` report held against
         per-stage counts from the host replay;
   (d)   ``fastx_quality_stats -Q 33`` and ``-Q 33 -N`` on the headline
         and the TruSeq lanes, and ``-Q 33`` on (a)'s small-RNA lane, with
         the ``device`` engine (``FASTX_STATS_PATH=device``: K5b on the
         pure-ACGT lanes' 2-bit codes, K5 on the small-RNA lane, whose
         blocks hold Ns), each held against a run with
         ``FASTX_STATS_PATH=host`` (the native histogram, the default; no
         kernel);
   (e)   ``fastx_collapser -Q 33 -v`` on a seeded 1M-read small-RNA lane
         with miRNA-like duplication (``synth_collapse_lane_bytes``, seed
         11), on the ``device`` engine (``FASTX_COLLAPSE_PATH=device``:
         the sort and segment sums of ``ops/collapse.py`` on cuda
         tensors) and the ``host`` engine (the native hash table), each held against a
         Python dict reference ordered by ``final_order`` and named by
         ``rank_count_column``; the collapsed FASTA collapsed again
         (counts from the names) must come back unchanged, and
         ``fastx_uncollapser`` on it must give the input's multiset of
         sequences; no kernel launches;
   (f)   the eight per-read tools on the headline lane with the headline
         chain's options and ``-v`` (``fasta_nucleotide_changer -r`` on
         ``fastq_to_fasta -n -r``'s output), each on the default engine
         (the raw-line host path where the tool has one: no transform
         runs) and with ``FASTX_LINEPATH=off`` (parse, then the
         transform on the card: every transform call's tensors on
         cuda), outputs and reports held equal; no kernel launches;
   (g)   ``fastx_barcode_splitter --bol --mismatches 1`` on a seeded 1M x
         100 bp lane with inline barcodes (``synth_barcode_lane_bytes``:
         24 six-base barcodes, 5 % of the reads without one, one or two
         substitutions in 12 %), then ``--eol --partial 1 --mismatches 1``
         on a 262,144-read lane with them at the 3' end: every output file
         and the summary held byte for byte against a numpy reference of
         the Perl's rule (``barcode_reference``), the matcher's results
         on the first 65,536 rows against ``barcode_match`` on CPU
         tensors (the plain path), its one call a run on cuda tensors, no
         kernel launches; then ``seqalign_test`` against its fixed text,
         ``fasta_formatter -w 60`` and ``-t`` on (e)'s collapsed FASTA
         against a plain formatter, and ``fastq_quality_converter -n``
         then ``-a`` on the headline lane's first 65,536 reads, which must
         give them back;
   (h)   the pod on the card: the headline and collapse lanes written to
         files, and N worker processes (``python3 chip_smoke.py --worker
         SPEC``, started with ``cli/pod.worker_env``'s environment, so
         every worker shares the one card and merges over gloo) each on
         its own byte range: at N = 2 the headline (K1, K2), ``-v``
         (classic, K4), ``fastx_quality_stats`` on both engines (K5b on
         ``device``), ``fastx_collapser -Q 33 -v`` on both engines,
         ``fastx_uncollapser -v`` on its merged output and
         ``fastq_quality_filter -q 20 -p 50 -v``: the per-read tools'
         shards concatenated, and the merged outputs, byte for byte
         against the outputs paths main, (c)-(f) held, the ``-v`` reports
         printed once, by rank 0, equal to the single-process reports;
         each worker's launch counters (K1, K2, K4, K5b; no K3), and the
         first launch of each kernel a worker made held against its
         plain version; then readings of the headline at N = 1, 2 and 4
         (the sharded run's wall between barriers, median of 3), the
         card's busy share at N = 2 (``torch.profiler`` in each worker),
         the collapser's merge seconds and ``os.cpu_count()``; then the
         launcher, ``fastx_pod_torch -n 2 -- fastx_pipeline``, once,
         its shards against the main path's output;
   mesh  ``parallel/mesh.py`` at world size 1 on NCCL (NCCL cannot put
         two ranks on one card): each ``sharded_*`` on 262,144 headline
         reads (the collapse lane's for the collapse, the barcode lane's
         for the tally) on the card against its single-device function on
         the same tensors, tolerance 0; ``sharded_pipeline`` on K4's
         counter, its launch against the plain version;
   (i)   the port's bench (``fastx_toolkit_tpu_torch/bench.py``) in
         process at 262,144 reads and 3 timed runs a mode: the headline,
         ``--config 1``-``5`` (3 and 5 on both engines), ``--device
         --config 0``, ``3`` and ``5`` and ``--host`` (``--scaling``,
         ``--pertool``, ``--meshsweep`` and ``--cbaseline`` left out for
         time: process starts, not kernels): each mode's metrics by
         name, every line naming the card; the dumped outputs of configs
         0-5 byte for byte against host references (the float32 host
         decisions, the stats CLI's host engine, the dict reference);
         configs 3 and 5 are the tools' own runs; K1 and K2 on the
         headline, config 4 and ``--device --config 0``, K5b on config
         3's device path and ``--device --config 3``, the first launch of
         each held against its plain version;
   (p)   the probe's entry point (``fastx_toolkit_tpu_torch.probe``'s
         ``measure``, budget 15 s): every variant timed at the DP shapes
         and the TPU's, its lines in ``probe.jsonl`` beside the build;
         each timed run's output held against the plain version (tolerance
         0); a ``smem`` kernel whose SASS shows fewer than one shared load
         and store a plane op fails;
5. times   — end-to-end reads/s of the headline (median of 3 runs after a
   warm-up) and of paths (a)-(g) (one timed run each; (d) and (e) on
   both engines, (f) on both per tool; (g) with the match's device time
   from ``torch.profiler``), and the device time of K1-K5b beside their plain versions
   and, for K5/K5b, ``torch.bincount`` on precomputed flat ids (CUDA
   events); each kernel's bound is the larger of its device-memory bytes
   over 3.35 TB/s and its int32 operations at the card's int32 issue
   rate (132 SMs x 4 schedulers x 32 lanes x the max SM clock: P's
   ``reg`` runs pass the 64 INT32 lanes an SM, so the issue rate is the
   ceiling); beside it, as readings and not as the bound: the same
   operations at the best ``reg`` int32 rate P reached at the kernel's H
   (``p_rate_ms``) and the bound from the assumed INT32-lane peak (SMs x
   64 lanes x the max SM clock; ``assumed_bound_ms``); no kernel keeps a
   row state in shared memory, so ``smem_state_ms`` is null; K4 also at
   path (c)'s shape (the headline lane's first 262,144 reads as ASCII, H
   = 17, L = 100) on a line of its own; the kernels alone by
   ``torch.profiler`` (``device_ms``: the events time the host's launch
   rate for a kernel shorter than it, as K2's); P's own
   entry is its ``reg`` dependent int32 run at [33 x 262,144] beside its
   plain version, bound the same way;
6. prints its own seconds, the kernels' JSON line, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero.  Without CUDA it exits 2 and prints no
result.
"""

import contextlib
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fastx_toolkit_tpu_torch import bench, probe, synth
from fastx_toolkit_tpu_torch.bench import (
    COUNT_OPS_PER_BASE,
    DP_OPS_PER_CELL,
    INT32_LANES,
    ISSUE_LANES,
    free_port,
    roofline,
)
from fastx_toolkit_tpu_torch.cli import pod
from fastx_toolkit_tpu_torch.cli.common import CliContext, run_tool_main
from fastx_toolkit_tpu_torch.cli.tools import (
    fasta_formatter,
    fasta_nucleotide_changer,
    fastq_masker,
    fastq_quality_converter,
    fastq_quality_filter,
    fastq_quality_trimmer,
    fastq_to_fasta,
    fastx_artifacts_filter,
    fastx_clipper,
    fastx_collapser,
    fastx_pipeline,
    fastx_quality_stats,
    fastx_reverse_complement,
    fastx_trimmer,
    fastx_uncollapser,
    seqalign_test,
)
from fastx_toolkit_tpu_torch.cli.tools._shared import (
    BatchReader,
    render_same_as_input,
)
from fastx_toolkit_tpu_torch.core import codec, native
from fastx_toolkit_tpu_torch.engine import hostfix
from fastx_toolkit_tpu_torch.engine import pipeline as pipeline_mod
from fastx_toolkit_tpu_torch.engine.lines import LineEngines, stream_pipeline_lines
from fastx_toolkit_tpu_torch.engine.pipeline import (
    PipelineConfig,
    _thresholds,
    _words_T,
    pack_batch2,
    packed_pipeline_body,
    packed_quality_stage,
    pipeline_body,
    to_device,
)
from fastx_toolkit_tpu_torch.kernels import (
    _build,
    align_cuda,
    align_unpacked_cuda,
    counts_cuda,
    probe_cuda,
    stats_cuda,
)
from fastx_toolkit_tpu_torch.kernels.align import align_batch
from fastx_toolkit_tpu_torch.kernels.probe import (
    CASES,
    TPU_B,
    TPU_K,
    TPU_U,
    plane_ops,
    plane_probe_plain,
)
from fastx_toolkit_tpu_torch.probe import cuda_ms
from fastx_toolkit_tpu_torch.ops import collapse as collapse_ops
from fastx_toolkit_tpu_torch.ops import stats as stats_ops
from fastx_toolkit_tpu_torch.ops import transforms
from fastx_toolkit_tpu_torch.ops.clipper import (
    adapter_cutoff_index,
    clip_cut_lengths,
    legacy_effective_query,
)
from fastx_toolkit_tpu_torch.parallel import mesh, multihost
from fastx_toolkit_tpu_torch.profile_paths import _busy_ms
from fastx_toolkit_tpu_torch.scripts import barcode_splitter

N_READS = 1_000_000
READ_LEN = 100
CHUNK = 262_144
SEED = 42
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
SMALL_RNA = b"TGGAATTCTCGGGTGCCAAGG"
HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")
CLIPPER_ARGV = ["-Q", "33", "-a", SMALL_RNA.decode(), "-l", "15", "-c", "-v"]
COLLAPSE_SEED = 11
# path (f): the eight per-read tools with the headline chain's options
# (fasta_nucleotide_changer on fastq_to_fasta's output), each with the
# transform its classic path calls
PER_READ = (
    (fastx_trimmer, ["-Q", "33", "-l", "90", "-v"], "trimmer"),
    (fastq_quality_filter, ["-Q", "33", "-q", "20", "-p", "50", "-v"],
     "quality_filter_keep"),
    (fastq_quality_trimmer, ["-Q", "33", "-t", "20", "-v"],
     "quality_trimmer"),
    (fastq_masker, ["-Q", "33", "-q", "20", "-v"], "masker"),
    (fastq_to_fasta, ["-Q", "33", "-n", "-r", "-v"], "fastq_to_fasta_keep"),
    (fastx_artifacts_filter, ["-Q", "33", "-v"], "artifacts_keep"),
    (fastx_reverse_complement, ["-Q", "33", "-v"], "reverse_complement"),
    (fasta_nucleotide_changer, ["-r", "-v"], "nucleotide_changer"),
)
# path (g): the splitter on a 1M-read lane with the barcodes at the 5'
# end, then on a 262,144-read lane with them at the 3' end and partial
# matches; the matcher's results held against the plain version on the
# first BARCODE_CHECK rows
BARCODE_RUNS = (
    (N_READS, True, ["--bol", "--mismatches", "1"]),
    (262_144, False, ["--eol", "--partial", "1", "--mismatches", "1"]),
)
BARCODE_CHECK = 65_536
# seqalign_test's fixed output (the reference's typos kept)
SEQALIGN_TEXT = (
    "Score-Matrix:\n"
    "- -      A        A        A        G        G        T        T"
    "        T        C        C        C        \n"
    "- -      0        0        0        0        0        0        0"
    "        0        0        0        0        \n"
    "A      0 M\\1.0    M\\1.0    M\\1.0    x\\-1.0   x\\-1.0   x\\-1.0"
    "   x\\-1.0   x\\-1.0   x\\-1.0   x\\-1.0   x\\-1.0\n"
    "G      0 x\\-1.0   x\\0.0    x\\0.0    M\\2.0    M\\0.0    x\\-2.0"
    "   x\\-2.0   x\\-2.0   x\\-2.0   x\\-2.0   x\\-2.0\n"
    "G      0 x\\-1.0   x\\-2.0   x\\-1.0   M\\1.0    M\\3.0    x\\-1.0"
    "   x\\-3.0   x\\-3.0   x\\-3.0   x\\-3.0   x\\-3.0\n"
    "C      0 x\\-1.0   x\\-2.0   x\\-3.0   x\\-2.0   x\\0.0    x\\2.0 "
    "   x\\-2.0   x\\-4.0   M\\-2.0   M\\-2.0   M\\-2.0\n"
    "T     -5 x\\-1.0   x\\-2.0   x\\-3.0   x\\-4.0   x\\-3.0   M\\1.0 "
    "   M\\3.0    M\\-1.0   x\\-5.0   x\\-3.0   x\\-3.0\n"
    "T    -10 x\\-6.0   x\\-2.0   x\\-3.0   x\\-4.0   x\\-5.0   M\\-2.0"
    "   M\\2.0    M\\4.0    x--1.0   x\\-6.0   x\\-4.0\n"
    "Query-Alingment = AGGTTT\n"
    "target-Alingment= AGGCTT\n"
    "Alignment NOT found\n"
    "Score = 4 (5 matches, 0 neutral-matches, 1 mismatches, 0 gaps) \n"
    "Query = AAAGGTTTCCC(qsize 11 qstart 2 qend 7\n"
    "Target= AGGCTT(tsize 6 tstart 0 tend 5\n"
    "\n"
    "A(AGGTTT)CCC\n"
    " (***|**)\n"
    "  (AGGCTT)\n")
# tools whose default engine runs no transform on a clean lane (the
# raw-line fast path; fastq_to_fasta -r renumbers on the classic path)
FAST_PATH_TOOLS = ("fastx_trimmer", "fastq_quality_filter",
                   "fastq_quality_trimmer", "fastq_masker",
                   "fastx_artifacts_filter")
FIELDS = ("matches", "mismatches", "gaps", "neutral", "query_start",
          "query_end", "target_start", "target_end", "tie_fragile")
KERNELS = ("align_packed12", "packed_counts", "align_packed", "align_unpacked",
           "align_unpacked_serial", "stats_hist", "stats_hist_b2",
           "stats_hist_tiled", "plane_probe")
META = {  # name -> (source, the TPU kernel it replaces)
    "align_packed12": ("fastx_toolkit_tpu_torch/csrc/align_packed.cu",
                       "fastx_toolkit_tpu/kernels/align_pallas.py:403"),
    "packed_counts": ("fastx_toolkit_tpu_torch/csrc/packed_counts.cu",
                      "fastx_toolkit_tpu/kernels/counts_pallas.py:31"),
    "align_packed": ("fastx_toolkit_tpu_torch/csrc/align_packed.cu",
                     "fastx_toolkit_tpu/kernels/align_pallas.py:638"),
    "align_unpacked": ("fastx_toolkit_tpu_torch/csrc/align_unpacked.cu",
                       "fastx_toolkit_tpu/kernels/align_pallas.py:157"),
    "align_unpacked_serial": ("fastx_toolkit_tpu_torch/csrc/align_unpacked.cu",
                              "fastx_toolkit_tpu/kernels/align_pallas.py:157"),
    "stats_hist": ("fastx_toolkit_tpu_torch/csrc/stats_hist.cu",
                   "fastx_toolkit_tpu/kernels/stats_pallas.py:56"),
    "stats_hist_b2": ("fastx_toolkit_tpu_torch/csrc/stats_hist.cu",
                      "fastx_toolkit_tpu/kernels/stats_pallas.py:56"),
    "stats_hist_tiled": ("fastx_toolkit_tpu_torch/csrc/stats_hist.cu",
                         "fastx_toolkit_tpu/kernels/stats_pallas.py:56"),
    "plane_probe": ("fastx_toolkit_tpu_torch/csrc/plane_probe.cu",
                    "bench.py:1274"),
}
# K3's checks at the edges of its lane groups (9 rows a lane): H at 1, k,
# k + 1, 2k, 2k + 1, 31-33, 4k, 4k + 1, 64 and 72
K3_EDGE_H = (1, 9, 10, 18, 19, 31, 32, 33, 36, 37, 64, 72)
# K4's checks at the edges of its (G, K) picks (align_unpacked_cuda.
# K4_TABLE_PICKS: 17, 21, 34, 72 and 128 rows; K4_COMPARE_PICKS: 8, 16,
# 32, 64 and 128): H at 1, each pick's first and last H, the CLIs' 99 and
# the gate's 127
K4_EDGE_H = (1, 8, 9, 16, 17, 18, 21, 22, 32, 33, 34, 35, 64, 65, 72, 73, 99,
             127)
# each kernel's name in the profiler's device events (phase 5's device_ms)
DEVICE_NAMES = {"align_packed12": "align_packed_kernel",
                "packed_counts": "packed_counts_kernel",
                "align_packed": "align_packed_kernel",
                "align_unpacked": "align_unpacked_kernel",
                "align_unpacked_serial": "align_serial_kernel",
                "stats_hist": "stats_tile_kernel",
                "stats_hist_b2": "stats_tile_kernel",
                "stats_hist_tiled": "stats_tiled_kernel"}
# K5's checks at the edges of its routes and tiles: L at 1, a word's edges,
# 64 and 65, the headline's 128, the one-tile kernel's widest (160) and
# past it (the tiled kernel)
K5_EDGE_L = (1, 31, 32, 33, 64, 65, 128, 160, 301)
# the probe's timed variant in the kernels line: the dependent int32 chain
# in registers at K3's TruSeq shape
PROBE_TIMED = ("reg", "dependent", False, 33, probe.DP_B)
# path (h): the worker counts of the headline's readings, the reads of the
# warm-up slice, the seconds a spawn of workers may take
POD_WORKERS = (2, 1, 4)
POD_WARM = 20_000
POD_TIMEOUT = 300
# path (i): the port's bench in process at BENCH_READS reads and
# BENCH_ITERS timed runs; each mode with its environment, the metrics it
# prints and the config whose output it dumps (None: no output)
BENCH_READS = 262_144
BENCH_ITERS = 3
BENCH_MODES = (
    ("default", [], {}, (bench.METRIC[0],), 0),
    ("--config 1", ["--config", "1"], {}, (bench.METRIC[1],), 1),
    ("--config 2", ["--config", "2"], {}, (bench.METRIC[2],), 2),
    ("--config 3", ["--config", "3"], {}, (bench.METRIC[3],), 3),
    ("--config 3, device path", ["--config", "3"],
     {"FASTX_STATS_PATH": "device"}, (bench.METRIC[3],), 3),
    ("--config 4", ["--config", "4"], {}, (bench.METRIC[4],), 4),
    ("--config 5", ["--config", "5"], {}, (bench.METRIC[5],), 5),
    ("--config 5, device path", ["--config", "5"],
     {"FASTX_COLLAPSE_PATH": "device"}, (bench.METRIC[5],), 5),
    ("--device --config 0", ["--device", "--config", "0"], {},
     ("reads_per_sec_device_resident_fused_step", "speed_of_light_config0",
      "device_stage_decomposition"), None),
    ("--device --config 3", ["--device", "--config", "3"], {},
     (bench.METRIC[3] + "_device_resident", "speed_of_light_config3"), None),
    ("--device --config 5", ["--device", "--config", "5"], {},
     (bench.METRIC[5] + "_device_resident", "speed_of_light_config5"), None),
    ("--host", ["--host"], {}, ("reads_per_sec_host_codec_only_lines",),
     None),
)
# the kernel launches each mode must count
BENCH_NEEDS = {"default": ("align_packed12", "packed_counts"),
               "--config 4": ("align_packed12", "packed_counts"),
               "--config 3, device path": ("stats_hist_b2",),
               "--device --config 0": ("align_packed12", "packed_counts"),
               "--device --config 3": ("stats_hist_b2",)}
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print("FAIL: " + msg, flush=True)
    sys.exit(1)


def counters():
    return {"align_packed12": align_cuda.launches,
            "packed_counts": counts_cuda.launches,
            "align_packed": align_cuda.wide_launches,
            "align_unpacked": align_unpacked_cuda.launches,
            "align_unpacked_serial": align_unpacked_cuda.serial_launches,
            "stats_hist": stats_cuda.launches,
            "stats_hist_b2": stats_cuda.b2_launches,
            "stats_hist_tiled": stats_cuda.tiled_launches,
            "plane_probe": probe_cuda.launches}


def reset_counters():
    align_cuda.launches = align_cuda.wide_launches = 0
    counts_cuda.launches = align_unpacked_cuda.launches = 0
    align_unpacked_cuda.serial_launches = 0
    stats_cuda.launches = stats_cuda.b2_launches = 0
    stats_cuda.tiled_launches = 0
    probe_cuda.launches = 0


def route_check(label, before, kernel):
    """Fail unless one adapter-DP or histogram call since ``before`` (a
    :func:`counters` reading) counted one launch on ``kernel``'s counter
    and none on any other."""
    after = counters()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved != {kernel: 1}:
        fail("%s: expected one launch of %s, counted %s"
             % (label, kernel, moved))


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


def adversarial(rng, B, L, adapter, n_frac, alphabet=b"ACGTN"):
    """Random reads over ``alphabet`` (N fraction ``n_frac`` when packed)
    with noisy adapters spiked in and random lengths 0..L: ASCII
    ``(bases, lengths)`` numpy arrays."""
    alpha = np.frombuffer(alphabet, np.uint8)
    if alphabet == b"ACGTN":
        bases = rng.choice(alpha, size=(B, L), p=[(1 - n_frac) / 4] * 4 + [n_frac])
    else:
        bases = rng.choice(alpha, size=(B, L))
    pos = rng.integers(0, max(1, L - len(adapter)), B)
    ad = np.frombuffer(adapter, np.uint8)
    for j in range(len(ad)):
        m = (rng.random(B) < 0.4) & (pos + j < L)
        col = np.where(rng.random(B) < 0.9, ad[j], rng.choice(alpha[:4], B))
        bases[m, (pos + j)[m]] = col[m]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = ord("A")
    return bases, lengths


def packed(bases, lengths, device):
    """ACGTN reads as the packed kernels' words ``(b2w, nmw, lengths)``."""
    B, L = bases.shape
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
    print("  %-40s equal on %d fields, %d rows, max_abs_err=%d"
          % (name, len(fields), len(got[fields[0]]), err), flush=True)
    return err


@contextlib.contextmanager
def launch_inputs(module, keep=lambda *args: True):
    """Keep a device copy of the inputs of every ``module._launch`` call
    made inside the block for which ``keep(*args)`` holds (a path run's
    own launches, at the path's shapes), so that each can be held against
    the plain version after the run."""
    seen = []
    launch = module._launch

    def kept(*args):
        if keep(*args):
            seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args))
        return launch(*args)

    module._launch = kept
    try:
        yield seen
    finally:
        module._launch = launch


@contextlib.contextmanager
def devices_of(module, names):
    """Record ``(name, device type of the first argument)`` for every call
    of ``module``'s functions ``names`` made inside the block."""
    seen = []
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            seen.append((name, args[0].device.type))
            return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def k3_launch(_b2w, _nmw, _lengths, codes, L, _tie_flag):
    """True for the packed launcher's K3 launches (outside K1's gate)."""
    return not align_cuda.packed12_ok(L, len(codes))


# the lane-group kernels, by source: align_packed_kernel<HAS_NM, TIE, G>
# (K1 and K3, align_cuda.K3_ROWS rows a lane) and
# align_unpacked_kernel<TABLE, G, K> (K4)
_LANE_KERNELS = {
    "align_packed.cu": re.compile(
        r"align_packed_kernelILb([01])ELb([01])ELi(\d+)EE"),
    "align_unpacked.cu": re.compile(
        r"align_unpacked_kernelILb([01])ELi(\d+)ELi(\d+)EE"),
}


def lane_sass_report(source, obj=None):
    """``{template arguments: {"instr_per_cell", "cells", "instr",
    "ops"}}`` for the hot loop of each instantiation of the lane-group
    kernel of ``source`` (``align_packed.cu``: (has_nm, tie, G), K3_ROWS
    cells a step; ``align_unpacked.cu``: (table, G, K), K cells a step) in
    ``obj`` (default: the paths' built library's object of ``source``),
    read with ``cuobjdump --dump-sass``.  A pass of the step loop is the
    cells of one lane.  Static counts: every instruction of the loop body
    once, whichever branch a lane takes.  Empty when cuobjdump or the
    object is missing."""
    if obj is None:
        obj = os.path.join(_build.BUILD_DIR, _build.build_key(),
                           source + ".o")
    pattern = _LANE_KERNELS[source]
    report = {}
    for name, body in probe.sass_functions(obj).items():
        m = pattern.search(name)
        hist = probe._hot_loop(body) if m else None
        if not hist:
            continue
        if source == "align_packed.cu":
            key = (m.group(1) == "1", m.group(2) == "1", int(m.group(3)))
            k = align_cuda.K3_ROWS
        else:
            key = (m.group(1) == "1", int(m.group(2)), int(m.group(3)))
            k = key[2]
        n = sum(hist.values())
        report[key] = {"instr_per_cell": n / k, "cells": k, "instr": n,
                       "ops": hist}
    return report


# K5's kernels and K2's, by source: stats_tile_kernel<B2> (the one-tile
# kernel) and stats_tiled_kernel<B2>; packed_counts_kernel<HAS_NM>
_COUNT_KERNELS = {
    "stats_hist.cu": re.compile(r"(stats_tiled?)_kernelILb([01])E"),
    "packed_counts.cu": re.compile(r"(packed_counts)_kernelILb([01])E"),
}


def count_sass_report(source, obj=None):
    """``{(kernel, flag): {"instr_per_base", "bases", "instr", "ops"}}``
    for the hot loop of each kernel of ``source`` in ``obj`` (default: the
    paths' built library's object), read with ``cuobjdump --dump-sass``:
    K5's (``stats_hist.cu``: the loop that holds the tally's ``ATOMS``, one
    a base; flag: the 2-bit mode) and K2's (``packed_counts.cu``: the loop
    that holds its ``POPC``, five a 16-base word with the N plane, four
    without; flag: the N plane).  Static counts, as
    :func:`lane_sass_report`'s.  Empty when cuobjdump or the object is
    missing."""
    if obj is None:
        obj = os.path.join(_build.BUILD_DIR, _build.build_key(),
                           source + ".o")
    pattern = _COUNT_KERNELS[source]
    need = "ATOMS" if source == "stats_hist.cu" else "POPC"
    report = {}
    for name, body in probe.sass_functions(obj).items():
        m = pattern.search(name)
        hist = probe._hot_loop(body, need=need) if m else None
        if not hist:
            continue
        key = (m.group(1), m.group(2) == "1")
        if need == "ATOMS":
            bases = hist["ATOMS"]
        else:
            bases = 16 * hist["POPC"] // (5 if key[1] else 4)
        n = sum(hist.values())
        report[key] = {"instr_per_base": n / bases, "bases": bases,
                       "instr": n, "ops": hist}
    return report


def device_ms(fn, reps, kernel):
    """Mean device milliseconds of the launches of kernels whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` after one warm-up call
    (``torch.profiler``: the kernels alone, without the host's time
    between launches); None when the profiler sees no such kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(spans) / len(spans) if spans else None


def device_total_ms(fn, reps):
    """Mean device milliseconds a call of ``fn`` keeps the card busy over
    ``reps`` calls after one warm-up call: every kernel and copy it
    launches, from ``torch.profiler`` (one stream, so the spans add)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps


def k4_edge_adapter(H, table):
    """An adapter of ``H`` bytes for K4's edge checks: over ACGT with N
    bases (the table variant), or over 12 letters, 7 or more distinct
    non-N bytes from H = 8 (the compare variant)."""
    ad = (b"ACGTN" + SMALL_RNA * 7 if table
          else b"ACGTNacgU" + b"tggaattcUcgggtgccaagg" * 7)[:H]
    if (align_unpacked_cuda.adapter_table(ad) is not None) != table:
        fail("K4 edge adapter at H=%d is not of the %s variant"
             % (H, "table" if table else "compare"))
    return ad


def stats_chunk(data):
    """The first CHUNK reads of a lane as the stats CLI's device path gives
    them to K5: numpy ``(bases, quals, lengths)``, width padded to 32."""
    batch = codec.parse(data[:record_cut(data, CHUNK)],
                        filetype=codec.FASTQ_ONLY, q_offset=33)
    return to_device(batch)[:3]


def probe_rates(results):
    """The rates P reached at the DP shapes: the best ``reg`` int32
    plane-op rate at each H and over all H, and the best ``smem`` int32
    read+write rate (bytes/s)."""
    at_h, smem = {}, 0.0
    for r in results:
        if r["dtype"] != "int32" or r["plane_shape"][1] != probe.DP_B:
            continue
        H = r["plane_shape"][0]
        if r["residence"] == "reg":
            at_h[H] = max(at_h.get(H, 0.0), r["ops_per_s"])
        else:
            smem = max(smem, r["bytes_per_s"])
    if not at_h or not smem:
        fail("the probe measured no reg or no smem int32 rate at B=%d"
             % probe.DP_B)
    return {"int32_at": at_h, "int32": max(at_h.values()), "smem": smem}


def probe_shapes():
    """Every (residence, case, dpx, H, B, smem_bytes) that phase 3 holds
    against the plain version: each run path (p) times, then the TPU's H
    at B = 262,144."""
    shapes = probe.runs()
    for case, (dep, H, _dtype) in CASES.items():
        for res in probe.RESIDENCES:
            for dpx in ((False, True) if dep else (False,)):
                shapes.append((res, case, dpx, H, probe.DP_B,
                               probe_cuda.smem_need(case, H)
                               if res == "smem" else 0))
    return shapes


def probe_check(label, got, case, H, plain, errs):
    """Hold one probe output against the plain version at the TPU's K and
    U (computed once a (case, H, B), kept in ``plain``); fails on any
    difference and returns row 0."""
    key = (case, H, got.shape[0])
    if key not in plain:
        plain[key] = plane_probe_plain(case, H, key[2], TPU_K, TPU_U,
                                       device=got.device)
    want = plain[key]
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    errs["plane_probe"] = max(errs["plane_probe"], err)
    if err:
        fail("%s: differs from the plain version (%d)" % (label, err))
    return int(want[0])


def probe_checks(dev, errs, plain):
    """Every probe variant on the card equal to the plain version
    (tolerance 0) at each shape of :func:`probe_shapes`, K and U the
    TPU's.  Returns the seconds taken."""
    t0 = time.perf_counter()
    for res, case, dpx, H, B, smem in probe_shapes():
        got = probe_cuda.plane_probe(
            case, torch.empty(B, dtype=CASES[case][2], device=dev), H=H,
            K=TPU_K, U=TPU_U, residence=res, dpx=dpx, smem_bytes=smem)
        label = "P %s %s [%d x %d]%s" % (
            res, probe.variant_name(case, dpx), H, B,
            " %d B a block" % smem if smem else "")
        row0 = probe_check(label, got, case, H, plain, errs)
        print("  %-52s equal, max_abs_err=0 (row 0 = %d)" % (label, row0),
              flush=True)
    return time.perf_counter() - t0


def run_main_path(data, cfg, engines, arena):
    args = SimpleNamespace(input_filename="<lane>", q_offset=33)
    reader = BatchReader(None, args, filetype=codec.FASTQ_ONLY,
                         stream=io.BytesIO(data))
    return stream_pipeline_lines(reader, cfg, out_fastq=True, q_offset=33,
                                 write=None, device=engines.device,
                                 arena=arena, chunk_rows=CHUNK,
                                 engines=engines)


def run_cli(tool, prog, argv, data):
    """One in-process run of a CLI's ``tool_main`` with the launch
    counters set to 0 just before: ``(status, stdout, report, seconds,
    launches)``; the ``-v`` report goes to stderr, captured."""
    stdout, stderr = io.BytesIO(), io.StringIO()
    ctx = CliContext(prog=prog, stdin=io.BytesIO(data), stdout=stdout,
                     stderr=stderr, stdout_text=sys.stdout)
    reset_counters()
    t0 = time.perf_counter()
    status = tool.tool_main(ctx, argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return status, stdout.getvalue(), stderr.getvalue(), secs, counters()


def check_bytes(label, got, want):
    if got != want:
        diff = next((i for i in range(min(len(got), len(want)))
                     if got[i] != want[i]), min(len(got), len(want)))
        fail("%s: output differs from the host reference at byte %d "
             "(%d vs %d bytes)" % (label, diff, len(got), len(want)))


def frames(data):
    """The lane's FASTQ frames, CHUNK records each."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
    n_rec = len(nl) // 4
    pos = 0
    for r0 in range(0, n_rec, CHUNK):
        end = int(nl[4 * min(n_rec, r0 + CHUNK) - 1]) + 1
        yield codec.frame_fastq_fast(data[pos:end])
        pos = end


def host_reference(data, cfg, out_fastq=True):
    """The lane's output rendered from float32 host decisions over every
    read (numpy and the native float32 clipper; no kernel runs)."""
    out = []
    n_kept = 0
    for fr in frames(data):
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
            keep.astype(np.uint8), out_fastq=out_fastq, q_offset=33,
            mask_thr=cfg.mask_q if cfg.with_mask else None))
    return b"".join(out), n_kept


def reader_over(data, filetype):
    args = SimpleNamespace(input_filename="<lane>", q_offset=33)
    return BatchReader(None, args, filetype=filetype, stream=io.BytesIO(data))


def clipper_reference(data):
    """Path (a)'s output and ``-v`` report from float32 host decisions over
    every read, with the legacy stale-matrix emulation carried across
    batches (numpy and the native float32 clipper; no kernel runs)."""
    out = []
    carry = None
    n = np.zeros(6, np.int64)  # input, then categories 1-5
    args = SimpleNamespace(q_offset=33)
    for batch in reader_over(data, codec.FASTA_OR_FASTQ):
        eff, widths, carry = legacy_effective_query(batch.bases,
                                                    batch.lengths, carry)
        new_len, write, cat = hostfix.clip_decide_np(
            batch.bases, batch.lengths, SMALL_RNA, min_length=15,
            keep_delta=0, discard_non_clipped=True, discard_clipped=False,
            keep_n=False, show_adapter_only=False, min_adapter_len=0,
            align_bases=eff, align_lengths=widths)
        cols = np.arange(batch.bases.shape[1])[None, :]
        batch.bases = np.where(cols < new_len[:, None], batch.bases, 0)
        batch.quals = np.where(cols < new_len[:, None], batch.quals, 0)
        batch.lengths = new_len
        n[0] += len(batch)
        for c in range(1, 6):
            n[c] += int((cat == c).sum())
        out.append(render_same_as_input(args, batch.select(write)))
    n_in, n_zero, n_short, n_nonclip, _n_clip, n_n = (int(v) for v in n)
    report = ("Clipping Adapter: %s\nMin. Length: 15\n"
              "Non-Clipped reads - discarded.\nInput: %d reads.\n"
              "Output: %d reads.\ndiscarded %d too-short reads.\n"
              "discarded %d adapter-only reads.\n"
              "discarded %d non-clipped reads.\ndiscarded %d N reads.\n"
              % (SMALL_RNA.decode(), n_in,
                 n_in - n_short - n_nonclip - n_n - n_zero, n_short, n_zero,
                 n_nonclip, n_n))
    return b"".join(out), report


def collapse_reference(data):
    """Path (e)'s output and ``-v`` report from a Python dict of sequence
    -> [count, first index] over the FASTQ lane, ordered by
    ``final_order`` and named by ``rank_count_column`` (neither engine
    runs)."""
    seqs = data.split(b"\n")[1::4]
    table = {}
    for i, seq in enumerate(seqs):
        ent = table.get(seq)
        if ent is None:
            table[seq] = [1, i]
        else:
            ent[0] += 1
    keys = list(table)
    counts = np.array([table[k][0] for k in keys], np.int64)
    first = np.array([table[k][1] for k in keys], np.int64)
    order = collapse_ops.final_order(counts, first)
    flat, offs = collapse_ops.rank_count_column(counts[order])
    names = flat.tobytes()
    out = b"".join(b">%s\n%s\n" % (names[offs[j]:offs[j + 1]], keys[o])
                   for j, o in enumerate(order))
    n = len(seqs)
    report = ("Input: %d sequences (representing %d reads)\n"
              "Output: %d sequences (representing %d reads)\n"
              % (n, n, len(keys), n))
    return out, report


def pipeline_report(data, chain):
    """Path (c)'s ``-v`` report from per-stage counts of the host replay
    (``host_replay_chain``: numpy and the native float32 clipper)."""
    ctx = CliContext(prog="fastx_pipeline")
    cfgs, _fasta = fastx_pipeline._stage_configs(
        ctx, fastx_pipeline.parse_chain(ctx, chain), True)
    totals = np.zeros(len(cfgs), np.int64)
    n_in = 0
    for batch in reader_over(data, codec.FASTQ_ONLY):
        *_, keep_after = fastx_pipeline.host_replay_chain(
            cfgs, batch.bases, batch.quals, batch.lengths)
        n_in += len(batch)
        totals += [int(k.sum()) for k in keep_after]
    lines = ["Fused pipeline: %d stages, one device program.\n" % len(cfgs),
             "Input: %d reads.\n" % n_in]
    lines += ["  %-28s -> %d reads.\n" % (c["kind"], int(t))
              for c, t in zip(cfgs, totals)]
    lines.append("Output: %d reads.\n" % int(totals[-1]))
    return "".join(lines)


def barcode_reference(lane, bcfile, *, bol, partial, mismatches, prefix,
                      suffix):
    """Path (g)'s output files and summary from the Perl's rule, in numpy
    (no matcher of the port runs): the barcodes in file order, each
    followed by its partial variants (trimmed 5' for ``bol``, 3' else);
    a read's fragment is its first or last barcode-length bases;
    mismatches are the positions where the fragment and the barcode,
    padded with zero bytes, differ (the Perl's string XOR), plus the
    variant's trimmed length; the scan keeps each strict improvement
    below the barcode length, and a read goes to its best barcode if that
    has at most ``mismatches``, else to ``unmatched``.  The lane's reads
    all have one length, longer than the barcodes."""
    bcs = []
    for line in bcfile.split(b"\n"):
        if not line or line.startswith(b"#"):
            continue
        ident, code = line.split()
        bcs.append((ident.decode(), code, 0))
        for p in range(1, partial + 1):
            bcs.append((ident.decode(), code[p:] if bol else code[:-p], p))
    blen = len(bcs[0][1])
    nl = np.flatnonzero(np.frombuffer(lane, np.uint8) == 0x0A)
    n = len(nl) // 4
    read_len = int(nl[1] - nl[0] - 1)
    if not (nl[1::4] - nl[0::4] - 1 == read_len).all() or read_len < blen:
        fail("(g) the reference takes reads of one length, at least %d"
             % blen)
    starts = np.concatenate([[0], nl[3::4][:-1] + 1])
    seq0 = nl[0::4] + 1
    cols = np.arange(blen) + (0 if bol else read_len - blen)
    frag = np.frombuffer(lane, np.uint8)[seq0[:, None] + cols[None, :]]
    best = np.full(n, blen)
    pick = np.full(n, -1)
    for k, (_ident, code, penalty) in enumerate(bcs):
        padded = np.zeros(blen, np.uint8)
        padded[:len(code)] = np.frombuffer(code, np.uint8)
        mm = (frag != padded[None, :]).sum(axis=1) + penalty
        better = mm < best
        best[better] = mm[better]
        pick[better] = k
    pick[best > mismatches] = -1
    idents = list(dict.fromkeys(b[0] for b in bcs)) + ["unmatched"]
    dest = np.array([idents.index(b[0]) for b in bcs] + [len(idents) - 1])[pick]
    ends = np.concatenate([starts[1:], [len(lane)]])
    files, counts = {}, {}
    for d, ident in enumerate(idents):
        rows = np.flatnonzero(dest == d)
        counts[ident] = len(rows)
        files[prefix + ident + suffix] = b"".join(
            lane[starts[i]:ends[i]] for i in rows.tolist())
    summary = "Barcode\tCount\tLocation\n" + "".join(
        "%s\t%d\t%s\n" % (i, counts[i], prefix + i + suffix)
        for i in sorted(idents)) + "total\t%d\n" % n
    return files, summary


@contextlib.contextmanager
def matcher_calls(rows):
    """Record every ``transforms.barcode_match`` call made inside the
    block: its bases' device type, its operands as passed, and CPU copies
    of the operands' and results' first ``rows`` rows (the barcode
    operands whole)."""
    calls = []
    match = transforms.barcode_match

    def kept(bases, lengths, barcodes, barcode_lens, penalties, **kw):
        out = match(bases, lengths, barcodes, barcode_lens, penalties, **kw)
        calls.append({
            "device": bases.device.type,
            "operands": (bases, lengths, barcodes, barcode_lens, penalties),
            "kw": kw,
            "cpu": tuple(a.cpu() for a in (bases[:rows], lengths[:rows],
                                            barcodes, barcode_lens,
                                            penalties)),
            "out": tuple(o[:rows].cpu() for o in out)})
        return out

    transforms.barcode_match = kept
    try:
        yield calls
    finally:
        transforms.barcode_match = match


def run_splitter(argv, data):
    """One in-process run of the port's ``fastx_barcode_splitter`` with
    the launch counters set to 0 just before: ``(status, summary,
    seconds, launches)``."""
    out, err = io.StringIO(), io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    status = barcode_splitter.main_io(argv, io.BytesIO(data), out, err)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if status != 0 or err.getvalue():
        fail("(g) fastx_barcode_splitter %s: status %d, stderr %r"
             % (" ".join(argv), status, err.getvalue()))
    return out.getvalue(), secs, counters()


def formatter_reference(fasta, width, tabular):
    """``fasta_formatter -w width`` or ``-t`` on a FASTA of one line a
    sequence, none empty."""
    lines = fasta.split(b"\n")
    out = []
    for name, seq in zip(lines[0::2], lines[1::2]):
        if tabular:
            out.append(name[1:] + b"\t" + seq + b"\n")
        else:
            out.append(name + b"\n" + b"".join(
                seq[i:i + width] + b"\n" for i in range(0, len(seq), width)))
    return b"".join(out)


@contextlib.contextmanager
def first_launches():
    """Keep device copies of the inputs of the first launch of each kernel
    made inside the block, by the counter the launch moves (K2 through the
    name ``engine/pipeline.py`` calls it by), so that each can be held
    against its plain version after the block."""
    kept = {}
    la, lu = align_cuda._launch, align_unpacked_cuda._launch
    ls, lc = stats_cuda._launch, pipeline_mod.packed_counts

    def keep(key, args):
        if key not in kept:
            kept[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args)

    def packed(*args):
        keep("align_packed12" if align_cuda.packed12_ok(args[4], len(args[3]))
             else "align_packed", args)
        return la(*args)

    def unpacked(*args):
        keep("align_unpacked" if align_unpacked_cuda.lanes_ok(
            args[0].shape[1], len(args[2])) else "align_unpacked_serial", args)
        return lu(*args)

    def hist(*args):
        b2, codes, quals = args[:3]
        keep("stats_hist_tiled" if not stats_cuda.tile_ok(
            quals.shape[1], codes.shape[1])
             else "stats_hist_b2" if b2 else "stats_hist", args)
        return ls(*args)

    def counts(*args):
        if args[0].is_cuda:
            keep("packed_counts", args)
        return lc(*args)

    align_cuda._launch, align_unpacked_cuda._launch = packed, unpacked
    stats_cuda._launch, pipeline_mod.packed_counts = hist, counts
    try:
        yield kept
    finally:
        align_cuda._launch, align_unpacked_cuda._launch = la, lu
        stats_cuda._launch, pipeline_mod.packed_counts = ls, lc


def check_kept(kept):
    """Each kept launch (:func:`first_launches`) run again on the kernel
    and on its plain version: ``{counter: (max_abs_err, shape)}``."""
    out = {}
    for key, args in kept.items():
        if key in ("align_packed12", "align_packed"):
            b2w, nmw, l_, codes, L_, tie = args
            got = align_cuda._launch(*args)
            want = align_cuda.align_batch_packed_plain(
                b2w, nmw, l_, bytes(b"ACGTN"[c] for c in codes), L=L_,
                tie_flag=tie)
            fields, shape = FIELDS if tie else FIELDS[:8], [b2w.shape[1], L_]
        elif key == "packed_counts":
            got = dict(zip(("worst", "ncnt"),
                           counts_cuda.packed_counts(*args)))
            want = dict(zip(("worst", "ncnt"),
                            counts_cuda.packed_counts_plain(*args)))
            fields = ("worst", "ncnt")
            shape = [args[0].shape[1], args[0].shape[0] * 16]
        elif key in ("align_unpacked", "align_unpacked_serial"):
            b_, l_, ad, tie = args
            got = align_unpacked_cuda._launch(*args)
            want = align_batch(b_, l_, ad, tie_flag=tie)
            fields, shape = FIELDS if tie else FIELDS[:8], list(b_.shape)
        else:
            b2, codes, q_, l_ = args
            plain = (stats_cuda.stats_hist_b2_plain if b2
                     else stats_cuda.stats_hist_plain)
            got = {"hist": stats_cuda._launch(*args).flatten()}
            want = {"hist": plain(codes, q_, l_).flatten()}
            fields, shape = ("hist",), list(q_.shape)
        torch.cuda.synchronize()
        out[key] = (max(int((got[f].long() - want[f].long()).abs().max())
                        if got[f].numel() else 0 for f in fields), shape)
    return out


@contextlib.contextmanager
def environ(env):
    """``os.environ`` with ``env`` set inside the block, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def worker_run(tool, argv, env):
    """One in-process run of the port's CLI ``tool`` as its process would
    run it (``run_tool_main``), with ``env`` set for the run and the launch
    counters set to 0 just before; fails on a status other than 0."""
    with environ(env):
        mod = importlib.import_module("fastx_toolkit_tpu_torch.cli.tools."
                                      + tool)
        sys.argv = [tool]
        reset_counters()
        t0 = time.perf_counter()
        status = run_tool_main(mod.tool_main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ln = counters()
        sys.stdout.flush()
    if status != 0:
        raise RuntimeError("%s %s exited with status %d"
                           % (tool, " ".join(argv), status))
    return {"tool": tool, "s": secs, "launches": ln}


def worker(spec_path):
    """``python3 chip_smoke.py --worker SPEC``: one process of path (h),
    started with ``cli/pod.worker_env``'s environment.  It runs SPEC's
    commands in order through ``run_tool_main`` (a barrier of the process
    group after each, so a command may read the merged output of the one
    before), each with the launch counters set to 0 just before and read
    just after, and times the collapser's table merge; then holds the
    first launch of each kernel it made against the kernel's plain
    version, and runs SPEC's timed headline (a warm-up on a slice, then
    runs between barriers, and one under ``torch.profiler``).  Its -v
    reports go to its stdout, and last a line ``WORKER {json}``."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    info = multihost.initialize()
    barrier = (torch.distributed.barrier if info.collective
               else (lambda: None))
    _build.library()
    merge_s = []
    merge = fastx_collapser.merge_tables

    def timed_merge(*args):
        t0 = time.perf_counter()
        out = merge(*args)
        merge_s.append(time.perf_counter() - t0)
        return out

    fastx_collapser.merge_tables = timed_merge
    runs = []
    with first_launches() as kept:
        for tool, argv, env in spec["cmds"]:
            del merge_s[:]
            runs.append(dict(worker_run(tool, argv, env),
                             merge_s=sum(merge_s)))
            barrier()
    fastx_collapser.merge_tables = merge
    checked = check_kept(kept)
    timed = spec.get("timed")
    res = {"rank": info.process_id, "runs": runs, "checked": checked}
    if timed:
        worker_run(timed["tool"], timed["warm"], {})
        walls = []
        for _ in range(timed["reps"]):
            barrier()
            t0 = time.perf_counter()
            worker_run(timed["tool"], timed["argv"], {})
            barrier()
            walls.append(time.perf_counter() - t0)
        res["walls"] = walls
        if timed["profile"]:
            barrier()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                worker_run(timed["tool"], timed["argv"], {})
                wall = time.perf_counter() - t0
            barrier()
            busy, by_name = _busy_ms(prof.events())
            res.update(profiled_wall=wall, busy_ms=busy, top=sorted(
                by_name.items(), key=lambda kv: -kv[1])[:5])
    if info.collective:
        torch.distributed.destroy_process_group()
    print("WORKER " + json.dumps(res), flush=True)
    return 0


def spawn_workers(n, spec, tmp, tag):
    """``n`` workers of path (h) on ``spec`` (:func:`worker`), each with
    ``cli/pod.worker_env``'s environment for its rank; the first that
    fails stops the others and fails the phase, as does a spawn past
    ``POD_TIMEOUT``.  Returns each rank's ``(stdout before its WORKER
    line, its JSON)``."""
    spec_p = os.path.join(tmp, tag + ".json")
    with open(spec_p, "w") as fh:
        json.dump(spec, fh)
    coord = "127.0.0.1:%d" % free_port()
    n_cards = torch.cuda.device_count()
    procs, files = [], []
    for rank in range(n):
        out_p, err_p = (os.path.join(tmp, "%s.%d.%s" % (tag, rank, x))
                        for x in ("out", "err"))
        files.append((out_p, err_p))
        with open(out_p, "wb") as fo, open(err_p, "wb") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 spec_p], env=pod.worker_env(rank, n, coord, n_cards=n_cards),
                stdout=fo, stderr=fe, cwd=ROOT))
    deadline = time.monotonic() + POD_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, (out_p, err_p) in zip(procs, files):
        with open(out_p) as fo, open(err_p) as fe:
            outs.append((fo.read(), fe.read()))
    if any(p.returncode != 0 for p in procs):
        fail("(h) %s: worker exit codes %s (negative: stopped by the smoke "
             "after another failed or the spawn passed %d s); stderr:\n%s"
             % (tag, [p.returncode for p in procs], POD_TIMEOUT, "\n".join(
                 "--- rank %d\n%s" % (r, e[-2000:])
                 for r, (_o, e) in enumerate(outs))))
    res = []
    for out, _err in outs:
        head, sep, line = out.rpartition("WORKER ")
        if not sep:
            fail("(h) %s: a worker printed no result" % tag)
        res.append((head, json.loads(line)))
    return res


def run_pod(argv):
    """The port's launcher (``python -m fastx_toolkit_tpu_torch.cli.pod
    ARGV``) in a session of its own, so that past ``POD_TIMEOUT`` it is
    stopped with every worker it started: ``(exit code, stdout,
    stderr)``."""
    p = subprocess.Popen([sys.executable, "-m",
                          "fastx_toolkit_tpu_torch.cli.pod", *argv],
                         cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=POD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        fail("(h) fastx_pod_torch %s passed %d s" % (" ".join(argv),
                                                     POD_TIMEOUT))
    return p.returncode, out, err


def shard_bytes(path, n):
    """The ``n`` shards of a per-read tool's output ``path``, concatenated
    in order; fails if the unsharded name exists too."""
    if os.path.exists(path):
        fail("(h) %s exists beside its shards" % path)
    parts = []
    for k in range(n):
        with open("%s.shard-%05d-of-%05d" % (path, k, n), "rb") as fh:
            parts.append(fh.read())
    return b"".join(parts)


def run_bench(argv, env, dump):
    """One in-process run of the port's bench (``bench.main(argv)``) with
    ``env``, ``FASTX_BENCH_ITERS=BENCH_ITERS`` and ``FASTX_BENCH_DUMP=dump``
    set for the run and the launch counters set to 0 just before: ``(JSON
    lines, seconds, launches)``; fails on a status other than 0."""
    out, err = io.StringIO(), io.StringIO()
    with environ(dict(env, FASTX_BENCH_ITERS=str(BENCH_ITERS),
                      FASTX_BENCH_DUMP=dump)):
        reset_counters()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                status = bench.main(argv)
        except BaseException:
            sys.stderr.write(err.getvalue()[-4000:])
            raise
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ln = counters()
    if status != 0:
        fail("(i) bench %s: status %d; stderr:\n%s"
             % (" ".join(argv), status, err.getvalue()[-4000:]))
    return [json.loads(x) for x in out.getvalue().splitlines()], secs, ln


def bench_path(launches, errs):
    """Path (i): every mode of ``BENCH_MODES`` through the port's bench in
    process at ``BENCH_READS`` reads, each with the launch counters set to
    0 just before and read just after (into ``launches``): its metrics by
    name, every line naming the card (name, power limit, count) and none
    with ``vs_baseline``; the dumped outputs of configs 0-5 byte for byte
    against host references that never touch a kernel (the float32 host
    decisions for 0, 1, 2 and 4, the stats CLI's host engine for 3, the
    dict reference for 5); the kernels each mode must launch
    (``BENCH_NEEDS``: K5b on config 3's device path and on ``--device
    --config 3``), and the first launch of each kernel held against its
    plain version (into ``errs``).  Returns each mode's ``(seconds,
    lines)``."""
    t_i = time.perf_counter()
    bench.N_READS = BENCH_READS
    lane = synth.synth_lane_bytes(BENCH_READS, READ_LEN)
    lane_4 = synth.synth_lane_bytes(bench.CONFIG_READS[4], READ_LEN)
    want = {}
    for n in (0, 1, 2, 4):
        cfg_n, fastq_n = bench.config_cfg(n)
        want[n] = host_reference(lane_4 if n == 4 else lane, cfg_n,
                                 fastq_n)[0]
    with environ({"FASTX_STATS_PATH": "host"}):
        status, want[3], _rep, _s, ln = run_cli(
            fastx_quality_stats, "fastx_quality_stats", ["-Q", "33"], lane)
    if status != 0 or any(ln.values()):
        fail("(i) the stats host reference: status %d, launches %s"
             % (status, ln))
    want[5] = collapse_reference(lane)[0]
    print("  (i) lanes %d and %d reads, host references (%.1f s)"
          % (BENCH_READS, bench.CONFIG_READS[4], time.perf_counter() - t_i),
          flush=True)
    dev_card = {"platform": "gpu", "name": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    res = {}
    with tempfile.TemporaryDirectory() as tmp, first_launches() as kept:
        dump = os.path.join(tmp, "dump")
        for label, argv, env, metrics, dump_n in BENCH_MODES:
            if os.path.exists(dump):
                os.remove(dump)
            lines, secs, ln = run_bench(argv, env, dump)
            launches["i " + label] = ln
            res[label] = (secs, lines)
            got = [r["metric"] for r in lines]
            if sorted(got) != sorted(metrics):
                fail("(i) bench %s printed %s, not %s" % (label, got,
                                                         list(metrics)))
            for r in lines:
                d = r["device"]
                if ({k: d.get(k) for k in dev_card} != dev_card
                        or not d.get("power_limit_w")
                        or "vs_baseline" in r):
                    fail("(i) bench %s: a line names %s as the card (%s)"
                         % (label, d, r["metric"]))
            if dump_n is not None:
                with open(dump, "rb") as fh:
                    check_bytes("(i) bench %s" % label, fh.read(),
                                want[dump_n])
            missing = [k for k in BENCH_NEEDS.get(label, ()) if ln[k] <= 0]
            if missing:
                fail("(i) bench %s launched no %s (%s)" % (label, missing,
                                                         ln))
            print("  (i) bench %-24s %6.1f s, %s%s; launches %s" % (
                label, secs, ", ".join(
                    "%s %s" % (r["metric"], r.get("value", r.get(
                        "pct_of_sol"))) for r in lines),
                "; output equals the host reference"
                if dump_n is not None else "", ln), flush=True)
    for k, (err, shape) in check_kept(kept).items():
        errs[k] = max(errs[k], err)
        if err:
            fail("(i) %s's first launch %s differs from the plain version "
                 "(%d)" % (k, shape, err))
        print("  (i) %s's first launch %s equals the plain version, "
              "max_abs_err=0" % (k, shape), flush=True)
    print("  (i) the bench's modes (%.1f s for the path)"
          % (time.perf_counter() - t_i), flush=True)
    return res


def main():
    t_main = time.perf_counter()
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    print("[1 device] %s | nvidia-smi: %s | max SM clock %.0f MHz | torch "
          "%s, CUDA %s" % (name, smi, clock_mhz, torch.__version__,
                           torch.version.cuda), flush=True)
    card = "%s, %s" % (name, smi.split(",")[-1].strip())
    clock_hz = clock_mhz * 1e6

    # 2. build: the paths' library and the probe's, all nvcc at once
    t0 = time.perf_counter()

    def timed_build(args):
        so_ = _build.build(*args)
        return so_, time.perf_counter() - t0

    with ThreadPoolExecutor(2) as ex:
        (so, so_s), (so_p, so_p_s) = ex.map(timed_build, [
            (), (_build.PROBE_SOURCES, _build.PROBE_LIB_NAME)])
    _build.library()
    _build.probe_library()
    print("[2 build] %.1f s -> %s; probe %.1f s -> %s"
          % (so_s, os.path.relpath(so), so_p_s, os.path.relpath(so_p)),
          flush=True)
    # per kernel: registers and spills; the probe's 72 instantiations
    # (6 H x 6 variants x 2 residences) in one summary line
    with open(os.path.join(os.path.dirname(so), "build.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.rstrip(), flush=True)
    probe_regs, probe_spill = [], 0
    with open(os.path.join(os.path.dirname(so_p), "build.log")) as fh:
        for line in fh:
            if "registers" in line:
                probe_regs.append(int(line.split("Used ")[1].split()[0]))
            elif "spill" in line:
                probe_spill += sum(int(w) for w in line.split()
                                   if w.isdigit())
    print("  plane_probe.cu: %d kernels, %d-%d registers, %d bytes of stack "
          "and spills in all" % (len(probe_regs), min(probe_regs, default=0),
                                 max(probe_regs, default=0), probe_spill),
          flush=True)
    # the lane-group kernels' hot loops: SASS instructions a DP cell, per
    # instantiation; the cells of the kernels line are the flagged ones at
    # the phase-5 shapes (K1 H = 17 and K3 H = 33 with the N plane, K4 the
    # table variant at H = 21)
    sass = {}
    for src in ("align_packed.cu", "align_unpacked.cu"):
        sass[src] = lane_sass_report(src)
        for key_, r_ in sorted(sass[src].items()):
            print("  %s %s: %d SASS instructions a step of %d cells, %.2f a "
                  "cell" % (src, " ".join(
                      "%s=%d" % kv for kv in zip(
                          ("HAS_NM", "TIE", "G") if src == "align_packed.cu"
                          else ("TABLE", "G", "K"), key_)),
                      r_["instr"], r_["cells"], r_["instr_per_cell"]),
                  flush=True)
    cell_instr = {
        "align_packed12": sass["align_packed.cu"].get(
            (True, True, align_cuda.k3_lanes(len(PipelineConfig().adapter))),
            {}).get("instr_per_cell"),
        "align_packed": sass["align_packed.cu"].get(
            (True, True, align_cuda.k3_lanes(len(TRUSEQ))), {}).get(
                "instr_per_cell"),
        "align_unpacked": sass["align_unpacked.cu"].get(
            (True, *align_unpacked_cuda.k4_pick(len(SMALL_RNA))), {}).get(
                "instr_per_cell")}
    # K5's and K2's hot loops: SASS instructions a base; the kernels line
    # takes the one-tile kernel's (both modes), the tiled kernel's ASCII
    # mode and K2's with the N plane
    count_sass = {}
    for src in ("stats_hist.cu", "packed_counts.cu"):
        for key_, r_ in sorted(count_sass_report(src).items()):
            count_sass[key_] = r_
            print("  %s %s %s=%d: %d SASS instructions a pass of %d bases, "
                  "%.2f a base" % (src, key_[0], "B2" if src == "stats_hist.cu"
                                   else "HAS_NM", key_[1], r_["instr"],
                                   r_["bases"], r_["instr_per_base"]),
                  flush=True)
    for k_, key_ in (("stats_hist", ("stats_tile", False)),
                     ("stats_hist_b2", ("stats_tile", True)),
                     ("stats_hist_tiled", ("stats_tiled", False)),
                     ("packed_counts", ("packed_counts", True))):
        cell_instr[k_] = count_sass.get(key_, {}).get("instr_per_base")
    # K5's route and the one-tile kernel's plan: the library's equal the
    # wrapper's mirror (the CPU tests' model runs the mirror)
    for B_, L_, W_, b2_ in ((CHUNK, 128, 128, False), (CHUNK, 160, 160, False),
                            (CHUNK, 128, 32, True), (1, 1, 1, False),
                            (5001, 33, 9, True), (8192, 301, 301, False),
                            (300, 100, 161, True), (10 ** 7, 4, 4, False)):
        lp_ = stats_cuda.library_plan(B_, L_, W_, b2_)
        got_ = ((lp_["blocks"], lp_["per"], lp_["R"], lp_["P"], lp_["smem"])
                if lp_["tile"] else None)
        want_ = (stats_cuda.k5_plan(B_, L_, W_, lp_["active"], lp_["optin"])
                 if stats_cuda.tile_ok(L_, W_) else None)
        if got_ != want_:
            fail("K5 plan at B=%d L=%d W=%d b2=%s: library %s, wrapper %s"
                 % (B_, L_, W_, b2_, got_, want_))
    lp_ = stats_cuda.library_plan(CHUNK, 128, 128, False)
    print("  K5's route and plan in the library equal the wrapper's; at "
          "%d x 128: %d clusters of %d resident, %d blocks of %d reads, %d "
          "reads a stage, %d B of shared memory a block (opt-in %d)"
          % (CHUNK, lp_["active"], stats_cuda.K5_CLUSTER, lp_["blocks"],
             lp_["per"], lp_["R"], lp_["smem"], lp_["optin"]), flush=True)
    # K4's gate and (G, K) picks: the library's equal the wrapper's
    lib = _build.library()
    for H_ in range(1, 140):
        for L_ in (50, 32700, 32768 - H_ - align_cuda._h_pad(H_)):
            for table_ in (True, False):
                want_ = (align_unpacked_cuda.k4_pick(H_, table_)
                         if align_unpacked_cuda.lanes_ok(L_, H_) else None)
                got_ = lib.fx_align_unpacked_pick(H_, L_, int(table_))
                got_ = (got_ >> 8, got_ & 255) if got_ else None
                if got_ != want_:
                    fail("K4 pick at H=%d L=%d table=%s: library %s, wrapper "
                         "%s" % (H_, L_, table_, got_, want_))
    print("  K4's gate and (G, K) picks in the library equal the wrapper's "
          "(H = 1-139, L = 50, 32,700 and the gate's edge, both variants)",
          flush=True)

    # 3. kernels vs plain, on the card
    cfg = PipelineConfig()
    cfg_ts = PipelineConfig(adapter=TRUSEQ)
    t0 = time.perf_counter()
    data = synth.synth_lane_bytes(N_READS, READ_LEN, seed=SEED)
    data_ts = synth.synth_lane_bytes(N_READS, 150, seed=SEED + 1,
                                     adapter=TRUSEQ)
    data_rna = synth.synth_small_rna_lane_bytes(N_READS, 50, seed=SEED + 2)
    print("[3 kernels] lanes: headline %d x %d bp (%d bytes), TruSeq %d x "
          "150 bp (%d bytes), small-RNA %d x 50 bp (%d bytes) (%.1f s)"
          % (N_READS, READ_LEN, len(data), N_READS, len(data_ts), N_READS,
             len(data_rna), time.perf_counter() - t0), flush=True)
    errs = dict.fromkeys(KERNELS, 0)

    def k_packed_check(label, b2w_, nmw_, l_, adapter_, L_, tie_flag=True):
        before = counters()
        got = align_cuda.align_batch_packed(b2w_, nmw_, l_, adapter_, L=L_,
                                            tie_flag=tie_flag)
        k = ("align_packed12" if align_cuda.packed12_ok(L_, len(adapter_))
             else "align_packed")
        route_check(label, before, k)
        want = align_cuda.align_batch_packed_plain(b2w_, nmw_, l_, adapter_,
                                                   L=L_, tie_flag=tie_flag)
        torch.cuda.synchronize()
        errs[k] = max(errs[k], compare(label, got, want,
                                       FIELDS if tie_flag else FIELDS[:8]))
        return got

    def k2_check(label, b2w_, nmw_, l_):
        before = counters()
        got = dict(zip(("worst", "ncnt"), counts_cuda.packed_counts(b2w_, nmw_, l_)))
        route_check(label, before, "packed_counts")
        want = dict(zip(("worst", "ncnt"),
                        counts_cuda.packed_counts_plain(b2w_, nmw_, l_)))
        torch.cuda.synchronize()
        errs["packed_counts"] = max(errs["packed_counts"],
                                    compare(label, got, want, ("worst", "ncnt")))

    def k4_check(label, bases_, l_, adapter_, tie_flag=True, plain_cols=None,
                 want=None):
        # plain_cols: hold against the plain version on the first columns
        # only, past every read's length (the rest never reach a result);
        # want: the plain version's flagged result on the same inputs (its
        # first 8 fields do not depend on the flags)
        before = counters()
        got = align_unpacked_cuda.align_batch_unpacked(bases_, l_, adapter_,
                                                       tie_flag=tie_flag)
        k = ("align_unpacked" if align_unpacked_cuda.lanes_ok(
            bases_.shape[1], len(adapter_)) else "align_unpacked_serial")
        route_check(label, before, k)
        if plain_cols is not None:
            if int(l_.max()) > plain_cols:
                fail("%s: a read is longer than the %d columns held"
                     % (label, plain_cols))
            bases_ = bases_[:, :plain_cols]
        if want is None:
            want = align_batch(bases_, l_, adapter_, tie_flag=tie_flag)
        torch.cuda.synchronize()
        errs[k] = max(errs[k], compare(
            label, got, want, FIELDS if tie_flag else FIELDS[:8]))
        return got, want

    def k5_check(label, codes_, q_, l_, b2=False):
        before = counters()
        if b2:
            got = stats_cuda.stats_hist_b2(codes_, q_, l_)
            want = stats_cuda.stats_hist_b2_plain(codes_, q_, l_)
        else:
            got = stats_cuda.stats_hist(codes_, q_, l_)
            want = stats_cuda.stats_hist_plain(codes_, q_, l_)
        k = ("stats_hist_tiled"
             if not stats_cuda.tile_ok(q_.shape[1], codes_.shape[1])
             else "stats_hist_b2" if b2 else "stats_hist")
        route_check(label, before, k)
        torch.cuda.synchronize()
        errs[k] = max(errs[k], compare(label, {"hist": got.flatten()},
                                       {"hist": want.flatten()}, ("hist",)))
        if int(got.sum()) != int(l_.clamp(0, q_.shape[1]).sum()):
            fail("%s: the histogram does not count every base once" % label)

    def k4_path_check(path, seen, n_launches):
        # after the run and its counters are read: these launches compare
        if len(seen) != n_launches:
            fail("path (%s): %d K4 launches counted, %d kept"
                 % (path, n_launches, len(seen)))
        for i, (b_, l_, ad_, tie_) in enumerate(seen):
            k4_check("K4 path (%s) launch %d [%d x %d] H=%d"
                     % (path, i, b_.shape[0], b_.shape[1], len(ad_)),
                     b_, l_, ad_, tie_flag=tie_)

    # K1 / K2 on the headline lane's first chunk
    fr = codec.frame_fastq_fast(data[:record_cut(data, CHUNK)])
    b2, planes, lengths, seq_len = pack_lane_chunk(fr, cfg, dev)
    l, _keep, b2w, nmw = packed_quality_stage(b2, planes, lengths, cfg,
                                              has_n_plane=False)
    adapter = cfg.adapter
    res = k_packed_check("K1 lane 262144 flagged", b2w, nmw, l, adapter,
                         seq_len)
    print("  (lane chunk: %d reads flagged tie_fragile)"
          % int(res["tie_fragile"].sum()), flush=True)
    k_packed_check("K1 lane 262144 nmw=None shortcut", b2w, None, l,
                   adapter, seq_len)
    new_len = clip_cut_lengths(adapter_cutoff_index(res, l), l)
    k2_check("K2 lane 262144 post-clip", b2w, nmw, new_len)
    k2_check("K2 lane 262144 no N plane", b2w, None, new_len)
    rng = np.random.default_rng(SEED)
    h31 = b"CCTTAAGGCCTTAAGGCCTTAAGGCCTTAAG"
    a_b2w, a_nmw, a_l = packed(*adversarial(rng, 8192, 100, h31, 0.05), dev)
    k_packed_check("K1 adversarial H=31 L=100", a_b2w, a_nmw, a_l, h31, 100)
    k2_check("K2 adversarial L=100", a_b2w, a_nmw, a_l)
    nad = b"CTGNAGGCANCATCAAT"
    k_packed_check("K1 adversarial N-adapter L=100", a_b2w, a_nmw, a_l, nad, 100)
    a_b2w, a_nmw, a_l = packed(*adversarial(rng, 2048, 511, adapter, 0.03), dev)
    k_packed_check("K1 adversarial H=17 L=511", a_b2w, a_nmw, a_l, adapter, 511)
    k2_check("K2 adversarial L=511", a_b2w, a_nmw, a_l)
    # K2 at its word edges: lengths 0, 1, 15-17, 31-33, the words' end and
    # past it, N bits at positions 0, 15, 16 and 31 of each 32 on every
    # fifth read, with and without the N plane
    edge_bits = (1 << 7) | (1 << 8) | (1 << 23) | (1 << 24)
    for L_ in (64, 150, 600):
        e_b2w, e_nmw, e_l = packed(*adversarial(rng, 3001, L_, adapter, 0.05),
                                   dev)
        e_nmw[:, 2::5] |= edge_bits
        W16_ = e_b2w.shape[0]
        e_l[:11] = torch.tensor([0, 1, 15, 16, 17, 31, 32, 33, W16_ * 16,
                                 W16_ * 16 + 7, -3], dtype=torch.int32)
        k2_check("K2 edges L=%d B=3001 N plane" % L_, e_b2w, e_nmw, e_l)
        k2_check("K2 edges L=%d B=3001" % L_, e_b2w, None, e_l)

    # K3 on the TruSeq lane's first chunk (the masker's plane as the N
    # plane, flags on), its no-N-plane shortcut, and H=72 at L=600
    fr_ts = codec.frame_fastq_fast(data_ts[:record_cut(data_ts, CHUNK)])
    b2, planes, lengths, seq_ts = pack_lane_chunk(fr_ts, cfg_ts, dev)
    l_ts, _keep, b2w_ts, nmw_ts = packed_quality_stage(
        b2, planes, lengths, cfg_ts, has_n_plane=False)
    res = k_packed_check("K3 TruSeq lane 262144 flagged", b2w_ts, nmw_ts,
                         l_ts, TRUSEQ, seq_ts)
    print("  (TruSeq chunk: %d reads flagged tie_fragile)"
          % int(res["tie_fragile"].sum()), flush=True)
    k_packed_check("K3 TruSeq lane 262144 nmw=None", b2w_ts, None, l_ts,
                   TRUSEQ, seq_ts)
    h72 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC" * 2 + b"ATCT"
    a_b2w, a_nmw, a_l = packed(*adversarial(rng, 2048, 600, h72, 0.05), dev)
    k_packed_check("K3 adversarial H=72 L=600", a_b2w, a_nmw, a_l, h72, 600)
    k_packed_check("K3 adversarial H=17 L=600", a_b2w, a_nmw, a_l, adapter, 600)
    # K3 at the edges of its lane groups, ragged B, lengths 0, 1, below the
    # lane count and L, and one long-read batch; each with and without the
    # N plane and the flags
    edge = [(H_, (b"ACGTN" + TRUSEQ * 3)[:H_] if H_ % 2 else (TRUSEQ * 3)[:H_],
             600 if H_ < 32 else 150, 1001) for H_ in K3_EDGE_H]
    edge.append((len(TRUSEQ), TRUSEQ, 4000, 256))
    for H_, ad_, L_, B_ in edge:
        e_b2w, e_nmw, e_l = packed(*adversarial(rng, B_, L_, ad_, 0.05), dev)
        e_l[:4] = torch.tensor([0, 1, max(0, align_cuda.k3_lanes(H_) - 1), L_])
        for nm_ in (e_nmw, None):
            for tie_ in (True, False):
                k_packed_check("K3 edge H=%d L=%d B=%d%s%s" % (
                    H_, L_, B_, "" if nm_ is None else " N plane",
                    " flags" if tie_ else ""), e_b2w, nm_, e_l, ad_, L_,
                    tie_flag=tie_)

    # K4 on the small-RNA lane's first chunk: ASCII, then the legacy
    # emulation's effective bases and running-max widths
    rna_batch = codec.parse(data_rna[:record_cut(data_rna, CHUNK)],
                            filetype=codec.FASTQ_ONLY, q_offset=33)
    rna_b = torch.from_numpy(rna_batch.bases).to(dev)
    rna_l = torch.from_numpy(rna_batch.lengths.astype(np.int32)).to(dev)
    k4_check("K4 small-RNA lane 262144 ASCII", rna_b, rna_l, SMALL_RNA)
    eff, widths, _carry = legacy_effective_query(rna_batch.bases,
                                                 rna_batch.lengths)
    eff_b = torch.from_numpy(eff).to(dev)
    eff_l = torch.from_numpy(widths).to(dev)
    k4_check("K4 small-RNA legacy-effective bases", eff_b, eff_l, SMALL_RNA)
    h99 = b"tggaattcUcgggtgccaagg" * 4 + b"ACGNNUuuuACGTNa"
    a_b, a_l = adversarial(rng, 4096, 300, h99, 0.0,
                           alphabet=b"ACGTNacgtnUu")
    a_b, a_l = torch.from_numpy(a_b).to(dev), torch.from_numpy(a_l).to(dev)
    k4_check("K4 adversarial H=99 lower/U L=300", a_b, a_l, h99)
    k4_check("K4 small-RNA B=1", rna_b[:1], rna_l[:1], SMALL_RNA)
    k4_check("K4 small-RNA B=300", rna_b[:300], rna_l[:300], SMALL_RNA)
    # K4 at each edge of its (G, K) picks on a ragged B, lengths 0, 1,
    # below the lane count and L on rows 1-4, in the table variant (ACGT
    # and N) and, from H = 8, the compare variant (12 letters), each with
    # and without the flags (the kernel computes them either way; the
    # wrapper leaves them out)
    for H_ in K4_EDGE_H:
        for table_ in (True, False) if H_ >= 8 else (True,):
            G_ = align_unpacked_cuda.k4_pick(H_, table_)[0]
            ad_ = k4_edge_adapter(H_, table_)
            e_b, e_l = adversarial(rng, 1001, 150, ad_, 0.05, alphabet=(
                b"ACGTN" if table_ else b"ACGTNacgtnUu"))
            e_l[1:5] = [0, 1, max(0, G_ - 1), 150]
            e_b = torch.from_numpy(e_b).to(dev)
            e_l = torch.from_numpy(e_l).to(dev)
            want_ = None
            for tie_ in (True, False):
                want_ = k4_check("K4 edge H=%d L=150 B=1001 %s%s" % (
                    H_, "table" if table_ else "compare",
                    " flags" if tie_ else ""), e_b, e_l, ad_,
                    tie_flag=tie_, want=want_)[1]
    # beyond the gate, the one-thread-per-read route: H = 128, and reads
    # of width 32,750 (L + H + H_pad >= 2^15) no longer than 1,000
    h128 = (SMALL_RNA * 7)[:128]
    sr_b, sr_l = adversarial(rng, 4096, 200, h128, 0.05)
    sr_b, sr_l = torch.from_numpy(sr_b).to(dev), torch.from_numpy(sr_l).to(dev)
    want_ = None
    for tie_ in (True, False):
        want_ = k4_check("K4 serial H=128 L=200 B=4096%s" % (
            " flags" if tie_ else ""), sr_b, sr_l, h128, tie_flag=tie_,
            want=want_)[1]
    w_b = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(64, 32750))
    w_l = rng.integers(0, 1001, 64).astype(np.int32)
    w_l[1:3] = [0, 1]
    k4_check("K4 serial L=32750 H=21 B=64 flags", torch.from_numpy(w_b).to(dev),
             torch.from_numpy(w_l).to(dev), SMALL_RNA, plain_cols=1000)

    # K5 on the first chunk of the headline and TruSeq lanes as the stats
    # CLI's device path gives them (L padded to 128 and 160), on one quality
    # value, on bytes outside ACGTN with qualities outside [-15, 93], at
    # B=1, B=300 and L=301; K5b on the headline chunk's 2-bit codes (the
    # lane is pure ACGT)
    s_np = stats_chunk(data)
    s_b, s_q, s_l = (torch.from_numpy(a).to(dev) for a in s_np)
    k5_check("K5 lane %d x %d" % tuple(s_b.shape), s_b, s_q, s_l)
    ts_b, ts_q, ts_l = (torch.from_numpy(a).to(dev)
                        for a in stats_chunk(data_ts))
    k5_check("K5 TruSeq lane %d x %d" % tuple(ts_b.shape), ts_b, ts_q, ts_l)
    k5_check("K5 lane %d x %d, one quality value" % tuple(s_b.shape), s_b,
             torch.full_like(s_q, 37), s_l)
    adv_b = rng.choice(np.frombuffer(b"ACGTNacgtnX.-*\0", np.uint8),
                       size=(65536, 128))
    adv_q = rng.integers(-128, 128, size=(65536, 128)).astype(np.int8)
    adv_l = rng.integers(-2, 140, 65536).astype(np.int32)
    k5_check("K5 adversarial bytes and qualities 65536 x 128",
             *(torch.from_numpy(a).to(dev) for a in (adv_b, adv_q, adv_l)))
    k5_check("K5 lane B=1", s_b[:1], s_q[:1], s_l[:1])
    k5_check("K5 lane B=300", s_b[:300], s_q[:300], s_l[:300])
    l301_b = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(8192, 301))
    l301_q = rng.integers(2, 42, size=(8192, 301)).astype(np.int8)
    l301_l = rng.integers(0, 302, 8192).astype(np.int32)
    k5_check("K5 random 8192 x 301",
             *(torch.from_numpy(a).to(dev) for a in (l301_b, l301_q, l301_l)))
    # K5 at the edges of its routes and tiles (K5_EDGE_L) in both modes, on
    # lengths 0, 1, L, past L and negative among random ones, and with the
    # quals at an odd address (the producer copies the bytes outside the
    # array's 16-byte chunks)
    for L_ in K5_EDGE_L:
        e_b = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(5001, L_))
        e_q = rng.integers(-20, 100, size=(5001, L_)).astype(np.int8)
        e_l = rng.integers(0, L_ + 1, 5001).astype(np.int32)
        e_l[:5] = [0, 1, L_, L_ + 9, -4]
        e_b2 = native.pack2(e_b, e_q, (), False)[0]
        e_b, e_q, e_l, e_b2 = (torch.from_numpy(a).to(dev)
                               for a in (e_b, e_q, e_l, e_b2))
        k5_check("K5 edge L=%d B=5001" % L_, e_b, e_q, e_l)
        k5_check("K5b edge L=%d B=5001" % L_, e_b2, e_q, e_l, b2=True)
        odd = torch.empty(e_q.numel() + 1, dtype=torch.int8,
                          device=dev)[1:].view(e_q.shape)
        odd.copy_(e_q)
        k5_check("K5 edge L=%d B=5001 quals at an odd address" % L_, e_b, odd,
                 e_l)
    # more reads than the resident blocks may tally into 16-bit halves
    # (clusters x 4 x 65,535), all on one base and one quality: every
    # count of a position lands in one bin
    lp_ = stats_cuda.library_plan(CHUNK, 4, 4, False)
    B_ = lp_["active"] * stats_cuda.K5_CLUSTER * stats_cuda.K5_CAP + 4097
    o_b = torch.full((B_, 4), ord("A"), dtype=torch.uint8, device=dev)
    o_q = torch.full((B_, 4), 37, dtype=torch.int8, device=dev)
    o_l = torch.full((B_,), 4, dtype=torch.int32, device=dev)
    k5_check("K5 %d reads on one bin (16-bit overflow)" % B_, o_b, o_q, o_l)
    del o_b, o_q, o_l
    s_b2 = torch.from_numpy(native.pack2(s_np[0], s_np[1], (), False)[0]).to(dev)
    k5_check("K5b lane %d x %d, 2-bit codes" % tuple(s_q.shape), s_b2, s_q,
             s_l, b2=True)
    if not torch.equal(stats_cuda.stats_hist_b2(s_b2, s_q, s_l),
                       stats_cuda.stats_hist(s_b, s_q, s_l)):
        fail("K5b and K5 differ on the headline chunk")

    # P: every probe variant at every shape path (p) times, and at the
    # TPU's H with B = 262,144
    p_plain = {}
    p_s = probe_checks(dev, errs, p_plain)
    print("  (P checks: %.1f s)" % p_s, flush=True)

    # 4. paths, each against a host reference that never touches a kernel
    launches = {}
    path_s = {}
    status, got, _rep, cli_s, ln = run_cli(fastx_pipeline, "fastx_pipeline",
                                           ["-Q", "33", HEADLINE], data)
    launches["main"] = ln
    t0 = time.perf_counter()
    want, want_kept = host_reference(data, cfg)
    print("[4 paths] main: fastx_pipeline '%s': status %d, %d reads in, %d "
          "out, %d bytes (%.2f s); host reference %d reads out (%.1f s); "
          "launches %s" % (HEADLINE, status, N_READS, got.count(b"\n") // 4,
                           len(got), cli_s, want_kept,
                           time.perf_counter() - t0, ln), flush=True)
    if status != 0:
        fail("fastx_pipeline exited with status %d" % status)
    check_bytes("main path", got, want)
    print("  output bytes equal the host reference", flush=True)
    if ln["align_packed12"] <= 0 or ln["packed_counts"] <= 0:
        fail("main path: K1 or K2 was not launched (%s)" % ln)
    # the same chain through the library entry point, which reports the
    # reads re-decided on the host; also the warm-up of the timed runs
    engines = LineEngines(cfg, dev)
    arena = np.empty(len(data) + (1 << 20), np.uint8)
    n_in, n_out, nbytes = run_main_path(data, cfg, engines, arena)
    print("  stream_pipeline_lines: %d reads in, %d out, %d flagged "
          "tie_fragile and re-decided on the host" % (n_in, n_out,
                                                       engines.fragile_rows),
          flush=True)
    if (n_in, n_out) != (N_READS, want_kept) or bytes(arena[:nbytes]) != want:
        fail("stream_pipeline_lines output differs from the host reference")

    # (a) the standalone clipper on the small-RNA lane
    with launch_inputs(align_unpacked_cuda) as seen_a:
        status, got, rep, path_s["a"], ln = run_cli(
            fastx_clipper, "fastx_clipper", CLIPPER_ARGV, data_rna)
    launches["a"] = ln
    t0 = time.perf_counter()
    want_a, want_rep = clipper_reference(data_rna)
    print("  (a) fastx_clipper %s: status %d, %d reads out (%.2f s); host "
          "reference (%.1f s); launches %s"
          % (" ".join(CLIPPER_ARGV), status, got.count(b"\n") // 4,
             path_s["a"], time.perf_counter() - t0, ln), flush=True)
    if status != 0:
        fail("fastx_clipper exited with status %d" % status)
    check_bytes("path (a)", got, want_a)
    if rep != want_rep:
        fail("path (a): the -v report differs:\n%s---\n%s" % (rep, want_rep))
    print("  (a) output bytes and -v report equal the host reference:\n    "
          + rep.rstrip().replace("\n", "\n    "), flush=True)
    if ln["align_unpacked"] <= 0:
        fail("path (a): K4 was not launched (%s)" % ln)
    k4_path_check("a", seen_a, ln["align_unpacked"])
    del seen_a

    # (b) the headline chain with the 33-base TruSeq adapter
    chain_b = HEADLINE.replace(cfg.adapter.decode(), TRUSEQ.decode())
    with launch_inputs(align_cuda, k3_launch) as seen_b:
        status, got, _rep, path_s["b"], ln = run_cli(
            fastx_pipeline, "fastx_pipeline", ["-Q", "33", chain_b], data_ts)
    launches["b"] = ln
    t0 = time.perf_counter()
    want_b, kept_b = host_reference(data_ts, cfg_ts)
    print("  (b) fastx_pipeline '%s': status %d, %d reads out (%.2f s); host "
          "reference %d out (%.1f s); launches %s"
          % (chain_b, status, got.count(b"\n") // 4, path_s["b"], kept_b,
             time.perf_counter() - t0, ln), flush=True)
    if status != 0:
        fail("path (b) exited with status %d" % status)
    check_bytes("path (b)", got, want_b)
    print("  (b) output bytes equal the host reference", flush=True)
    if ln["align_packed"] <= 0 or ln["packed_counts"] <= 0 \
            or ln["align_packed12"] != 0:
        fail("path (b): expected K3 and K2 launches and no K1 (%s)" % ln)
    # after the counters are read: each K3 launch against the plain version
    if len(seen_b) != ln["align_packed"]:
        fail("path (b): %d K3 launches counted, %d kept"
             % (ln["align_packed"], len(seen_b)))
    for i, (bw_, nw_, l_, codes_, L_, tie_) in enumerate(seen_b):
        got_ = align_cuda._launch(bw_, nw_, l_, codes_, L_, tie_)
        want_ = align_cuda.align_batch_packed_plain(
            bw_, nw_, l_, TRUSEQ, L=L_, tie_flag=tie_)
        torch.cuda.synchronize()
        errs["align_packed"] = max(errs["align_packed"], compare(
            "K3 path (b) launch %d [%d x %d]%s" % (
                i, bw_.shape[1], L_, " flags" if tie_ else ""),
            got_, want_, FIELDS if tie_ else FIELDS[:8]))
    del seen_b

    # (c) -v: the classic per-batch loop on the headline lane
    with launch_inputs(align_unpacked_cuda) as seen_c:
        status, got, rep, path_s["c"], ln = run_cli(
            fastx_pipeline, "fastx_pipeline", ["-v", "-Q", "33", HEADLINE],
            data)
    launches["c"] = ln
    t0 = time.perf_counter()
    want_rep = pipeline_report(data, HEADLINE)
    print("  (c) fastx_pipeline -v: status %d, %d reads out (%.2f s); host "
          "replay counts (%.1f s); launches %s"
          % (status, got.count(b"\n") // 4, path_s["c"],
             time.perf_counter() - t0, ln), flush=True)
    if status != 0:
        fail("path (c) exited with status %d" % status)
    check_bytes("path (c)", got, want)
    if rep != want_rep:
        fail("path (c): the -v report differs:\n%s---\n%s" % (rep, want_rep))
    print("  (c) output bytes and -v report equal the host reference:\n    "
          + rep.rstrip().replace("\n", "\n    "), flush=True)
    rep_c = rep
    if ln["align_unpacked"] <= 0:
        fail("path (c): K4 was not launched (%s)" % ln)
    k4_path_check("c", seen_c, ln["align_unpacked"])
    del seen_c

    # (d) fastx_quality_stats, old and -N formats, on the two pure-ACGT
    # lanes (the device engine's K5b) and the old format on the small-RNA
    # lane, whose blocks hold Ns (K5), against the host engine (the
    # default)
    stats_s, stats_want = {}, {}
    for lane, lane_data, formats, kernel in (
            ("headline", data, (["-Q", "33"], ["-Q", "33", "-N"]),
             "stats_hist_b2"),
            ("TruSeq", data_ts, (["-Q", "33"], ["-Q", "33", "-N"]),
             "stats_hist_b2"),
            ("small-RNA", data_rna, (["-Q", "33"],), "stats_hist")):
        for argv in formats:
            label = "(d) fastx_quality_stats %s, %s lane" % (" ".join(argv),
                                                             lane)
            os.environ["FASTX_STATS_PATH"] = "device"
            try:
                with launch_inputs(stats_cuda) as seen_d:
                    status, got, _rep, dev_s, ln = run_cli(
                        fastx_quality_stats, "fastx_quality_stats", argv,
                        lane_data)
                launches["d %s %s" % (lane, " ".join(argv))] = ln
                os.environ["FASTX_STATS_PATH"] = "host"
                h_status, want_d, _rep, host_s, h_ln = run_cli(
                    fastx_quality_stats, "fastx_quality_stats", argv,
                    lane_data)
            finally:
                del os.environ["FASTX_STATS_PATH"]
            stats_s[(lane, argv[-1] == "-N")] = (dev_s, host_s)
            print("  %s: status %d, %d lines, device engine %.2f s, "
                  "launches %s; host engine %.2f s" % (
                      label, status, got.count(b"\n"), dev_s, ln, host_s),
                  flush=True)
            if status != 0 or h_status != 0:
                fail("%s exited with status %d / %d (host)"
                     % (label, status, h_status))
            check_bytes(label, got, want_d)
            stats_want[(lane, tuple(argv))] = want_d
            other = ("stats_hist" if kernel == "stats_hist_b2"
                     else "stats_hist_b2")
            if ln[kernel] <= 0 or ln[other] or any(h_ln.values()):
                fail("%s: launches %s on the device engine (expected %s), "
                     "%s on the host engine" % (label, ln, kernel, h_ln))
            if len(seen_d) != ln[kernel]:
                fail("%s: %d %s launches counted, %d kept"
                     % (label, ln[kernel], kernel, len(seen_d)))
            for i, (b2_, c_, q_, l_) in enumerate(seen_d):
                k5_check("%s path (d) launch %d [%d x %d]"
                         % ("K5b" if b2_ else "K5", i, q_.shape[0],
                            q_.shape[1]), c_, q_, l_, b2=b2_)
            del seen_d
    print("  (d) outputs equal the host engine's on the three lanes and "
          "both formats", flush=True)

    # (e) fastx_collapser -Q 33 -v on a 1M-read small-RNA lane with
    # miRNA-like duplication, on the device engine and the host engine
    # (FASTX_COLLAPSE_PATH), each against a dict reference; the collapsed
    # FASTA collapsed again (counts from the names) must come back
    # unchanged, and uncollapsing it gives the input's multiset back
    t_e = time.perf_counter()
    data_col = synth.synth_collapse_lane_bytes(N_READS, seed=COLLAPSE_SEED)
    t0 = time.perf_counter()
    want_e, want_rep_e = collapse_reference(data_col)
    print("  (e) lane: %d reads, %d distinct (%.1f s to generate, %.1f s "
          "for the dict reference)" % (N_READS, want_e.count(b"\n") // 2,
                                       t0 - t_e, time.perf_counter() - t0),
          flush=True)
    collapse_s = {}
    for engine in ("device", "host"):
        os.environ["FASTX_COLLAPSE_PATH"] = engine
        try:
            if engine == "device":  # warm-up: the first sorts on the card
                run_cli(fastx_collapser, "fastx_collapser", ["-Q", "33"],
                        data_col[:record_cut(data_col,
                                             min(N_READS, 20000))])
            with devices_of(collapse_ops, ("collapse",
                                           "collapse_hashed")) as seen_e:
                status, got, rep, collapse_s[engine], ln = run_cli(
                    fastx_collapser, "fastx_collapser", ["-Q", "33", "-v"],
                    data_col)
                r_status, again, r_rep, _s, r_ln = run_cli(
                    fastx_collapser, "fastx_collapser", ["-v"], got)
        finally:
            os.environ.pop("FASTX_COLLAPSE_PATH", None)
        launches["e " + engine] = ln
        label = "(e) fastx_collapser, %s engine" % engine
        print("  %s: status %d, %d sequences out (%.2f s), %d dedup calls "
              "on %s; re-collapse of its FASTA: status %d" % (
                  label, status, got.count(b"\n") // 2, collapse_s[engine],
                  len(seen_e), sorted({d for _n, d in seen_e}), r_status),
              flush=True)
        if status != 0 or r_status != 0:
            fail("%s exited with status %d / %d (re-collapse)"
                 % (label, status, r_status))
        check_bytes(label, got, want_e)
        if rep != want_rep_e:
            fail("%s: the -v report differs:\n%s---\n%s"
                 % (label, rep, want_rep_e))
        check_bytes(label + ", re-collapsed", again, want_e)
        n_uniq = want_e.count(b"\n") // 2
        want_r_rep = ("Input: %d sequences (representing %d reads)\n"
                      "Output: %d sequences (representing %d reads)\n"
                      % (n_uniq, N_READS, n_uniq, N_READS))
        if r_rep != want_r_rep:
            fail("%s, re-collapsed: the -v report differs:\n%s---\n%s"
                 % (label, r_rep, want_r_rep))
        dedup_devices = {d for _n, d in seen_e}
        if engine == "device" and (not seen_e or dedup_devices != {"cuda"}):
            fail("%s: the dedup ran on %s" % (label, seen_e[:4]))
        if engine == "host" and seen_e:
            fail("%s: the device dedup ran %d times" % (label, len(seen_e)))
        if any(ln.values()) or any(r_ln.values()):
            fail("%s: kernel launches %s / %s" % (label, ln, r_ln))
    u_status, back, u_rep, _s, _ln = run_cli(
        fastx_uncollapser, "fastx_uncollapser", ["-v"], want_e)
    in_seqs = sorted(data_col.split(b"\n")[1::4])
    if u_status != 0 or sorted(back.split(b"\n")[1::2]) != in_seqs:
        fail("(e) fastx_uncollapser: status %d, the sequences differ from "
             "the input's multiset" % u_status)
    want_u_rep = ("Input: %d sequences (representing %d reads)\n"
                  "Output: %d sequences (representing %d reads)\n"
                  % (n_uniq, N_READS, N_READS, N_READS))
    if u_rep != want_u_rep:
        fail("(e) fastx_uncollapser: the -v report differs:\n%s---\n%s"
             % (u_rep, want_u_rep))
    unc_want = back
    del in_seqs, back
    print("  (e) outputs, -v reports and re-collapses equal the dict "
          "reference on both engines; uncollapsed: the input's %d "
          "sequences (%.1f s for the path)\n    %s" % (
              N_READS, time.perf_counter() - t_e,
              want_rep_e.rstrip().replace("\n", "\n    ")), flush=True)

    # (f) the eight per-read tools on the headline lane, each on the
    # default engine (the raw-line fast path where the tool has one) and
    # with FASTX_LINEPATH=off (parse, then the transform on the card):
    # outputs and -v reports equal, the classic runs' tensors on cuda
    t_f = time.perf_counter()
    per_read_s = {}
    fasta_in = None
    for tool, argv, fn in PER_READ:
        prog = tool.__name__.rsplit(".", 1)[1]
        inp = fasta_in if tool is fasta_nucleotide_changer else data
        runs = {}
        for engine in ("default", "off"):
            if engine == "off":
                os.environ["FASTX_LINEPATH"] = "off"
            try:
                with devices_of(transforms, (fn,)) as seen_f:
                    runs[engine] = run_cli(tool, prog, argv, inp) + (
                        list(seen_f),)
            finally:
                os.environ.pop("FASTX_LINEPATH", None)
        (st0, out0, rep0, s0, ln0, seen0), (st1, out1, rep1, s1, ln1,
                                            seen1) = runs.values()
        per_read_s[prog] = (s0, s1)
        launches["f " + prog] = ln1
        print("  (f) %s %s: status %d / %d, %d bytes out; default engine "
              "%.2f s (%d transform calls), FASTX_LINEPATH=off %.2f s (%d "
              "calls on %s)" % (prog, " ".join(argv), st0, st1, len(out0),
                                s0, len(seen0), s1, len(seen1),
                                sorted({d for _n, d in seen1})), flush=True)
        if st0 != 0 or st1 != 0:
            fail("(f) %s exited with status %d / %d (off)" % (prog, st0, st1))
        check_bytes("(f) %s, FASTX_LINEPATH=off against the default" % prog,
                    out1, out0)
        if rep1 != rep0 or not rep0:
            fail("(f) %s: the -v reports differ:\n%s---\n%s"
                 % (prog, rep0, rep1))
        if not seen1 or {d for _n, d in seen1} != {"cuda"}:
            fail("(f) %s: the classic run's transforms ran on %s"
                 % (prog, seen1[:4]))
        if prog in FAST_PATH_TOOLS and seen0:
            fail("(f) %s: the default engine ran %d transforms on a clean "
                 "lane" % (prog, len(seen0)))
        if any(ln0.values()) or any(ln1.values()):
            fail("(f) %s: kernel launches %s / %s" % (prog, ln0, ln1))
        if tool is fastq_to_fasta:
            fasta_in = out0
        if tool is fastq_quality_filter:
            filt_want = (argv, out0, rep0)
    del fasta_in
    print("  (f) each tool's outputs and -v reports equal on both engines "
          "(%d reads, %.1f s for the path)" % (
              N_READS, time.perf_counter() - t_f), flush=True)

    # (g) fastx_barcode_splitter on the card: each lane of BARCODE_RUNS,
    # its files and summary against the numpy reference, the matcher's
    # results on the first BARCODE_CHECK rows against the plain version
    # (the same function on CPU tensors), every call on cuda, no kernel
    t_g = time.perf_counter()
    barcode_s = {}
    for n_bc, bol, bc_argv in BARCODE_RUNS:
        t0 = time.perf_counter()
        lane, bcfile = synth.synth_barcode_lane_bytes(n_bc, READ_LEN, bol=bol)
        gen_s = time.perf_counter() - t0
        label = "(g) fastx_barcode_splitter %s" % " ".join(bc_argv)
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "bc.txt"), "wb") as fh:
                fh.write(bcfile)
            prefix = os.path.join(tmp, "out") + os.sep
            os.mkdir(prefix)
            argv = ["--bcfile", os.path.join(tmp, "bc.txt"), "--prefix",
                    prefix, "--suffix", ".fq"] + bc_argv
            with matcher_calls(BARCODE_CHECK) as calls:
                summary, secs, ln = run_splitter(argv, lane)
            t0 = time.perf_counter()
            want_files, want_summary = barcode_reference(
                lane, bcfile, bol=bol, partial=1 if "--partial" in bc_argv
                else 0, mismatches=1, prefix=prefix, suffix=".fq")
            ref_s = time.perf_counter() - t0
            if summary != want_summary:
                fail("%s: the summary differs from the reference:\n%s---\n%s"
                     % (label, summary, want_summary))
            got_names = sorted(os.path.join(prefix, f)
                               for f in os.listdir(prefix))
            if got_names != sorted(want_files):
                fail("%s: files %s, the reference's %s"
                     % (label, got_names, sorted(want_files)))
            for fname, want_f in want_files.items():
                with open(fname, "rb") as fh:
                    check_bytes("%s, %s" % (label, os.path.basename(fname)),
                                fh.read(), want_f)
        launches["g " + ("bol" if bol else "eol")] = ln
        if [c["device"] for c in calls] != ["cuda"]:
            fail("%s: the matcher ran on %s" % (label,
                                                [c["device"] for c in calls]))
        if any(ln.values()):
            fail("%s: kernel launches %s" % (label, ln))
        call = calls[0]
        plain = transforms.barcode_match(*call["cpu"], **call["kw"])
        for g_, w_ in zip(call["out"], plain):
            if not torch.equal(g_, w_):
                fail("%s: the matcher's results on the card differ from the "
                     "plain version on its first %d rows" % (label,
                                                             BARCODE_CHECK))
        ops = call["operands"]
        if bol:
            bc_mesh = (*(o[:CHUNK].clone() for o in ops[:2]),
                       *ops[2:], call["kw"])
        match_ms = device_total_ms(lambda: transforms.barcode_match(
            *ops, **call["kw"]), 5)
        barcode_s[label] = (n_bc, secs, match_ms)
        counts = summary.splitlines()[1:-1]
        print("  %s: %d reads, %.3f s, %.0f reads/s; the match %.3f ms of "
              "device time (torch.profiler, its kernels alone, [%d x %d] "
              "against %d barcodes) on %s; files and summary equal the "
              "numpy reference (%.1f s; %.1f s to generate the lane), the "
              "results on the first %d rows the plain version's; %s ... %s"
              % (label, n_bc, secs, n_bc / secs, match_ms, ops[0].shape[0],
                 ops[0].shape[1], ops[2].shape[0], card, ref_s, gen_s,
                 BARCODE_CHECK, counts[0], counts[-1]), flush=True)
        del lane, calls, call, ops, want_files
    # the host-only tools once each, on small inputs
    text = io.StringIO()
    reset_counters()
    status = seqalign_test.tool_main(CliContext(
        prog="seqalign_test", stdin=io.BytesIO(), stdout=io.BytesIO(),
        stderr=io.StringIO(), stdout_text=text), [])
    ln_t = counters()
    if status != 0 or text.getvalue() != SEQALIGN_TEXT:
        fail("(g) seqalign_test: status %d, output differs from the fixed "
             "text" % status)
    for argv, want_t in ((["-w", "60"],
                          formatter_reference(want_e, 60, False)),
                         (["-t"], formatter_reference(want_e, 0, True))):
        status, got, _rep, _s, ln_f = run_cli(fasta_formatter,
                                              "fasta_formatter", argv, want_e)
        if status != 0 or any(ln_f.values()):
            fail("(g) fasta_formatter %s: status %d, launches %s"
                 % (" ".join(argv), status, ln_f))
        check_bytes("(g) fasta_formatter %s" % " ".join(argv), got, want_t)
    head = data[:record_cut(data, BARCODE_CHECK)]
    status, num, _rep, _s, ln_n = run_cli(
        fastq_quality_converter, "fastq_quality_converter",
        ["-Q", "33", "-n"], head)
    status2, back, _rep, _s, ln_a = run_cli(
        fastq_quality_converter, "fastq_quality_converter",
        ["-Q", "33", "-a"], num)
    if (status, status2) != (0, 0) or num == head or any(
            ln_n.values()) or any(ln_a.values()) or any(ln_t.values()):
        fail("(g) fastq_quality_converter: status %d / %d" % (status, status2))
    check_bytes("(g) fastq_quality_converter -n then -a", back, head)
    print("  (g) seqalign_test equals its fixed text; fasta_formatter -w 60 "
          "and -t on (e)'s %d sequences equal a plain formatter; "
          "fastq_quality_converter -n then -a gives the headline lane's "
          "first %d reads back (%.1f s for the path)" % (
              want_e.count(b"\n") // 2, BARCODE_CHECK,
              time.perf_counter() - t_g), flush=True)

    # (h) the pod on the card: the headline and collapse lanes as files,
    # N worker processes sharing the card (cli/pod.worker_env), each on
    # its own byte range, merging over gloo; shards and merged outputs
    # against the single-process outputs the earlier paths held, the -v
    # reports once from rank 0, each kernel the workers launched against
    # its plain version; then the headline's readings at 1, 2 and 4
    # workers and fastx_pod_torch -n 2 once
    t_h = time.perf_counter()
    h_readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        def tmp_p(name):
            return os.path.join(tmp, name)

        for fname, blob in (("lane.fq", data), ("col.fq", data_col),
                            ("head.fq", data[:record_cut(data, POD_WARM)])):
            with open(tmp_p(fname), "wb") as fh:
                fh.write(blob)
        lane_p = tmp_p("lane.fq")
        filt_argv, filt_out, filt_rep = filt_want
        stats_h = stats_want[("headline", ("-Q", "33"))]
        # (name, tool, argv, env, want, merged, -v report)
        h_cmds = [
            ("head", "fastx_pipeline", ["-Q", "33", "-i", lane_p], {}, want,
             False, ""),
            ("classic", "fastx_pipeline", ["-v", "-Q", "33", "-i", lane_p],
             {}, want, False, rep_c),
            ("stats_device", "fastx_quality_stats", ["-Q", "33", "-i",
                                                     lane_p],
             {"FASTX_STATS_PATH": "device"}, stats_h, True, ""),
            ("stats_host", "fastx_quality_stats", ["-Q", "33", "-i", lane_p],
             {"FASTX_STATS_PATH": "host"}, stats_h, True, ""),
            ("col_device", "fastx_collapser", ["-Q", "33", "-v", "-i",
                                               tmp_p("col.fq")],
             {"FASTX_COLLAPSE_PATH": "device"}, want_e, True, want_rep_e),
            ("col_host", "fastx_collapser", ["-Q", "33", "-v", "-i",
                                             tmp_p("col.fq")],
             {"FASTX_COLLAPSE_PATH": "host"}, want_e, True, want_rep_e),
            ("unc", "fastx_uncollapser", ["-v", "-i", tmp_p("col_host")], {},
             unc_want, False, want_u_rep),
            ("filt", "fastq_quality_filter", filt_argv + ["-i", lane_p], {},
             filt_out, False, filt_rep),
        ]
        spec = {"cmds": [[tool, ["-o", tmp_p(nm)] + argv + (
            [HEADLINE] if tool == "fastx_pipeline" else []), env]
            for nm, tool, argv, env, _w, _m, _r in h_cmds]}
        for n_w in POD_WORKERS:
            spec["timed"] = {
                "tool": "fastx_pipeline", "reps": 3, "profile": n_w == 2,
                "argv": ["-Q", "33", "-i", lane_p, "-o", tmp_p("timed"),
                         HEADLINE],
                "warm": ["-Q", "33", "-i", tmp_p("head.fq"), "-o",
                         tmp_p("warm"), HEADLINE]}
            t0 = time.perf_counter()
            res = spawn_workers(n_w, spec, tmp, "pod%d" % n_w)
            spawn_s = time.perf_counter() - t0
            walls = res[0][1]["walls"]
            h_readings[n_w] = (sorted(walls)[1], walls, spawn_s, res)
            if n_w != 2:
                continue
            spec = {"cmds": []}  # the outputs are checked once, at 2
            # outputs: shards of per-read tools, merged outputs once
            for nm, tool, _a, env, want_h, merged, _r in h_cmds:
                got = (open(tmp_p(nm), "rb").read() if merged
                       else shard_bytes(tmp_p(nm), 2))
                if merged and os.path.exists(tmp_p(nm) + ".shard-00000-of-"
                                                         "00002"):
                    fail("(h) %s: a merged output has shards" % nm)
                check_bytes("(h) %s %s at 2 workers" % (tool, nm), got,
                            want_h)
            reports = [head for head, _j in res]
            want_reports = "".join(r for *_x, r in h_cmds)
            if reports != [want_reports, ""]:
                fail("(h) the -v reports differ from the single-process "
                     "ones (rank 0, then rank 1):\n%s---\n%s---\nwant:\n%s"
                     % (reports[0], reports[1], want_reports))
            merge_s = []
            for _head, js in res:
                rank = js["rank"]
                for (nm, tool, *_x), run in zip(h_cmds, js["runs"]):
                    ln = run["launches"]
                    launches["h %s rank %d" % (nm, rank)] = ln
                    need = {"head": ("align_packed12", "packed_counts"),
                            "classic": ("align_unpacked",),
                            "stats_device": ("stats_hist_b2",)}.get(nm, ())
                    if any(ln[k] <= 0 for k in need) or (
                            not need and any(ln.values())) or (
                            nm == "head" and ln["align_packed"]):
                        fail("(h) rank %d %s: launches %s (expected %s)"
                             % (rank, nm, ln, need or "none"))
                    if tool == "fastx_collapser":
                        merge_s.append((nm, rank, run["merge_s"]))
                    print("  (h) rank %d %s %s: %.3f s, launches %s"
                          % (rank, tool, nm, run["s"], ln), flush=True)
                for k in ("align_packed12", "packed_counts",
                          "align_unpacked", "stats_hist_b2"):
                    if k not in js["checked"]:
                        fail("(h) rank %d kept no launch of %s" % (rank, k))
                for k, (err, shape) in js["checked"].items():
                    errs[k] = max(errs[k], err)
                    print("  (h) rank %d: %s's first launch %s equals the "
                          "plain version, max_abs_err=%d" % (rank, k, shape,
                                                              err),
                          flush=True)
                    if err:
                        fail("(h) rank %d: %s differs from its plain "
                             "version" % (rank, k))
            h_merge = merge_s
            print("  (h) at 2 workers: outputs equal the single-process "
                  "outputs byte for byte (shards concatenated, merged "
                  "outputs once), the -v reports print once, from rank 0",
                  flush=True)
        # the port's launcher as a user runs it, once
        t0 = time.perf_counter()
        rc, _out, err = run_pod(
            ["-n", "2", "--coordinator", "127.0.0.1:%d" % free_port(), "--",
             "fastx_pipeline", "-Q", "33", "-i", lane_p, "-o", tmp_p("pod"),
             HEADLINE])
        pod_s = time.perf_counter() - t0
        if rc != 0:
            fail("(h) fastx_pod_torch -n 2: exit %d\n%s" % (rc, err[-3000:]))
        check_bytes("(h) fastx_pod_torch -n 2 fastx_pipeline",
                    shard_bytes(tmp_p("pod"), 2), want)
    print("  (h) fastx_pod_torch -n 2 -- fastx_pipeline -Q 33 (headline): "
          "shards equal the main path's output, %.2f s from launch to exit"
          % pod_s, flush=True)
    for n_w in sorted(h_readings):
        med, walls, spawn_s, _res = h_readings[n_w]
        print("  (h) reading: headline through %d worker%s: %.0f reads/s "
              "(the sharded run's wall between barriers on rank 0, median "
              "of 3: %s s; spawn %.1f s in all) on %s"
              % (n_w, "s" if n_w > 1 else "", N_READS / med,
                 ", ".join("%.3f" % w for w in walls), spawn_s, card),
              flush=True)
    res2 = h_readings[2][3]
    busy2 = sum(js["busy_ms"] for _h, js in res2)
    wall2 = max(js["profiled_wall"] for _h, js in res2)
    print("  (h) reading: card busy at 2 workers: %.2f ms of a %.3f s "
          "profiled run = %.2f %% (the sum of the workers' busy ms); "
          "largest device items: %s; os.cpu_count() = %s on %s" % (
              busy2, wall2, 100 * busy2 / 1e3 / wall2, "; ".join(
                  "rank %d %s %.3f ms" % (js["rank"], k_[:60], v_)
                  for _h, js in res2 for k_, v_ in js["top"][:3]),
              os.cpu_count(), card), flush=True)
    print("  (h) reading: the collapser's table allgather and merge at 2 "
          "workers: %s on %s; path (h) %.1f s" % (", ".join(
              "%s rank %d %.3f s" % m_ for m_ in h_merge), card,
              time.perf_counter() - t_h), flush=True)

    # mesh: parallel/mesh.py at world size 1 on NCCL (NCCL cannot put two
    # ranks on one card), each sharded_* on the headline lane's first
    # CHUNK reads on the card against its single-device function on the
    # same tensors, tolerance 0
    t_m = time.perf_counter()
    mesh.distributed_init(backend="nccl",
                          init_method="tcp://127.0.0.1:%d" % free_port(),
                          world_size=1, rank=0)
    if not torch.distributed.is_initialized() \
            or "nccl" not in str(torch.distributed.get_backend()):
        fail("mesh: the NCCL process group did not form")
    m = mesh.data_mesh(1)
    if m.device_type != "cuda":
        fail("mesh: the mesh is on %s" % m.device_type)
    hb = codec.parse(data[:record_cut(data, CHUNK)],
                     filetype=codec.FASTQ_ONLY, q_offset=33)
    mb, mq, ml, mc = mesh.shard_batch(m, *to_device(hb))
    if not mb.is_cuda:
        fail("mesh: shard_batch left the rows on %s" % mb.device)

    def mesh_equal(what, got_, want_):
        for i_, (g_, w_) in enumerate(zip(got_, want_)):
            if not torch.equal(g_, w_):
                fail("mesh: %s output %d differs from the single-device "
                     "function's" % (what, i_))
        print("  mesh %-24s equal to the single-device function on %d "
              "outputs" % (what, len(want_)), flush=True)

    mesh_equal("sharded_stats", mesh.sharded_stats(m, mb, mq, ml, mc,
                                                   is_fastq=True),
               stats_ops.accumulate(mb, mq, ml, mc, is_fastq=True))
    reset_counters()
    with first_launches() as kept_m:
        got_m = mesh.sharded_pipeline(m)(mb, mq, ml, mc)
    launches["mesh"] = counters()
    if launches["mesh"]["align_unpacked"] <= 0:
        fail("mesh: sharded_pipeline launched no K4 (%s)" % launches["mesh"])
    cfg_s = PipelineConfig(with_stats=True)
    want_m = pipeline_body(mb, mq, ml, cfg_s, counts=mc)
    mesh_equal("sharded_pipeline", got_m, want_m[:4] + want_m[5:])
    for k, (err, shape) in check_kept(kept_m).items():
        errs[k] = max(errs[k], err)
        if err:
            fail("mesh: %s differs from its plain version" % k)
        print("  mesh K4 (%s) launch %s equals the plain version" % (k, shape),
              flush=True)
    mb2, mpl = (torch.from_numpy(a).cuda() for a in pack_batch2(
        hb.bases, hb.quals, cfg_s, n_plane=True))
    L_h = int(hb.bases.shape[1])
    got_m = mesh.sharded_packed_pipeline(m, seq_len=L_h)(mb2, mpl, ml, mc)
    want_m = packed_pipeline_body(mb2, mpl, ml, cfg_s, seq_len=L_h,
                                  two_bit=True, counts=mc)
    mesh_equal("sharded_packed_pipeline", got_m, want_m[:2] + want_m[3:])
    hc = codec.parse(data_col[:record_cut(data_col, CHUNK)],
                     filetype=codec.FASTQ_ONLY, q_offset=33)
    w_ = torch.from_numpy(collapse_ops.pack_words(hc.bases).view(
        np.int32)).cuda()
    c_ = torch.ones(len(hc), dtype=torch.int32, device=dev)
    f_ = torch.arange(len(hc), dtype=torch.int32, device=dev)
    perm, head, seg_id, seg_counts, seg_first = collapse_ops.collapse(w_, c_,
                                                                      f_)
    sid = seg_id.long()
    mesh_equal("sharded_collapse", mesh.sharded_collapse(m, w_, c_, f_), (
        w_[perm], torch.where(head, seg_counts[sid], 0).to(torch.int32),
        torch.where(head, seg_first[sid], 2 ** 31 - 1).to(torch.int32)))
    bb_, bl_, bcs_, bcl_, pen_, kw_ = bc_mesh
    ident_of = torch.arange(bcs_.shape[0], dtype=torch.int32, device=dev)
    idx_, mm_ = transforms.barcode_match(bb_, bl_, bcs_, bcl_, pen_, **kw_)
    hit = (idx_ >= 0) & (mm_ <= 1)
    ident_ = torch.where(hit, ident_of[idx_.clamp(min=0).long()],
                         bcs_.shape[0]).long()
    mesh_equal("sharded_barcode_counts", mesh.sharded_barcode_counts(
        m, bb_, bl_, bcs_, bcl_, pen_, mismatches=1,
        n_idents=bcs_.shape[0], ident_of_barcode=ident_of.cpu().numpy(),
        **kw_), (torch.where(hit, ident_, -1).to(torch.int32),
                 torch.bincount(ident_, minlength=bcs_.shape[0] + 1).to(
                     torch.int32)))
    torch.distributed.destroy_process_group()
    del mb, mq, ml, mc, mb2, mpl, w_, c_, f_, bc_mesh, kept_m, got_m, want_m
    print("  mesh: the five sharded_* equal their single-device functions "
          "on %d reads on the card at world size 1 (NCCL) (%.1f s)"
          % (CHUNK, time.perf_counter() - t_m), flush=True)

    # (i) the port's bench in process: every mode but --pertool,
    # --meshsweep and --cbaseline, the dumped outputs of configs 0-5
    # against host references, K5b on config 3's device path
    bench_res = bench_path(launches, errs)
    for line in (r for _s, lines in bench_res.values() for r in lines):
        print("    " + json.dumps(line), flush=True)

    # (p) the probe's entry point (python -m fastx_toolkit_tpu_torch.probe)
    # with a budget of 15 s; its int32 and shared-memory rates give the
    # bounds of phase 5
    reset_counters()
    t0 = time.perf_counter()
    p_lines = []
    p_results, p_sass = probe.measure(dev, budget_s=15.0, card_name=smi,
                                      emit=p_lines.append)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches["p"] = counters()
    p_file = os.path.join(os.path.dirname(so_p), "probe.jsonl")
    with open(p_file, "w") as fh:
        fh.write("\n".join(p_lines) + "\n")
        for key, rep_ in sorted(p_sass.items()):
            fh.write(json.dumps({"sass": list(key), **rep_}) + "\n")
    print("  (p) probe: %d runs in %.1f s, launches %s (lines in %s)"
          % (len(p_results), probe_s, launches["p"], os.path.relpath(p_file)),
          flush=True)
    for r in p_results:
        print("    %-36s %-13s %9.3f ms  %.4g op/s%s  SASS/op %s" % (
            r["metric"], r["plane_shape"], r["ms"], r["ops_per_s"],
            "  %.4g B/s" % r["bytes_per_s"] if r["bytes_per_s"] else "",
            "n/a" if r["sass_instr_per_op"] is None
            else "%.3f" % r["sass_instr_per_op"]), flush=True)
    if launches["p"]["plane_probe"] <= 0 or any(
            v for k, v in launches["p"].items() if k != "plane_probe"):
        fail("path (p): expected probe launches only (%s)" % launches["p"])
    # after the counters are read: each timed run's output against the
    # plain version at the same case, H and B
    for r in p_results:
        probe_check("(p) %s %s" % (r["metric"], r["plane_shape"]), r["out"],
                    r["case"], r["plane_shape"][0], p_plain, errs)
    print("  (p) every timed run's output equals the plain version (%d "
          "runs, max_abs_err %d)" % (len(p_results), errs["plane_probe"]),
          flush=True)
    for r in p_results:
        if r["residence"] == "smem" and r["sass_lds_per_op"] is not None \
                and (r["sass_lds_per_op"] < 1 or r["sass_sts_per_op"] < 1):
            fail("%s: the SASS shows fewer than one shared load and store a "
                 "plane op: the plane was kept in registers" % r["metric"])
    rates = probe_rates(p_results)
    print("  P's best rates: int32 (reg) %s op/s, at H %s; smem "
          "(read+write) %.4g B/s on %s" % (
              "%.4g" % rates["int32"],
              ", ".join("%d: %.4g" % kv for kv in sorted(
                  rates["int32_at"].items())), rates["smem"], card),
          flush=True)

    # 5. times
    times = []
    for it in range(3):
        t0 = time.perf_counter()
        _n, _o, nb = run_main_path(data, cfg, engines, arena)
        times.append(time.perf_counter() - t0)
        if bytes(arena[:nb]) != want:
            fail("timed run %d output differs" % it)
    med = sorted(times)[1]
    print("[5 times] headline end to end: %.0f reads/s, %.1f MB/s in "
          "(median of 3 after a warm-up; runs %s s) on %s"
          % (N_READS / med, len(data) / med / 1e6,
             ", ".join("%.3f" % t for t in times), card), flush=True)
    for p, what in (("a", "fastx_clipper small-RNA 1M x 50"),
                    ("b", "fastx_pipeline TruSeq 1M x 150"),
                    ("c", "fastx_pipeline -v (classic loop) 1M x 100")):
        print("  path (%s) %s: %.0f reads/s (one run, %.3f s) on %s"
              % (p, what, N_READS / path_s[p], path_s[p], card), flush=True)
    for engine, secs in collapse_s.items():
        print("  path (e) fastx_collapser -Q 33 -v, %s engine: %.0f reads/s "
              "(one run, %.3f s) on %s" % (engine, N_READS / secs, secs,
                                           card), flush=True)
    for prog, (s0, s1) in per_read_s.items():
        print("  path (f) %s: default engine %.0f reads/s (%.3f s), "
              "FASTX_LINEPATH=off %.0f reads/s (%.3f s), one run each, %d "
              "reads, on %s" % (prog, N_READS / s0, s0, N_READS / s1, s1,
                                N_READS, card), flush=True)
    for label, (n_bc, secs, match_ms) in barcode_s.items():
        print("  path %s: %.0f reads/s (one run, %.3f s, %d reads; the match "
              "%.3f ms on the card) on %s" % (label, n_bc / secs, secs, n_bc,
                                              match_ms, card), flush=True)
    for (lane, new_fmt), (dev_s, host_s) in stats_s.items():
        print("  path (d) fastx_quality_stats%s %s lane: device engine %.0f "
              "reads/s (%.3f s), host engine %.0f reads/s (%.3f s), one run "
              "each on %s" % (" -N" if new_fmt else "", lane,
                              N_READS / dev_s, dev_s, N_READS / host_s,
                              host_s, card), flush=True)

    # device times at the phase-3 shapes, with each run's work for the bound
    lens_k1 = l.clamp(max=seq_len)
    lens_k3 = l_ts.clamp(max=seq_ts)
    shapes = {
        "align_packed12": (
            lambda: align_cuda.align_batch_packed(b2w, nmw, l, adapter,
                                                  L=seq_len, tie_flag=True),
            lambda: align_cuda.align_batch_packed_plain(
                b2w, nmw, l, adapter, L=seq_len, tie_flag=True),
            int(lens_k1.sum()) * len(adapter) * DP_OPS_PER_CELL,
            (b2w.numel() + nmw.numel() + l.numel() + 9 * l.numel()) * 4,
            "%d reads x %d bp, H=%d" % (CHUNK, seq_len, len(adapter))),
        "packed_counts": (
            lambda: counts_cuda.packed_counts(b2w, nmw, new_len),
            lambda: counts_cuda.packed_counts_plain(b2w, nmw, new_len),
            int(new_len.sum()) * COUNT_OPS_PER_BASE,
            (b2w.numel() + nmw.numel() + 3 * new_len.numel()) * 4,
            "%d reads x %d bp" % (CHUNK, seq_len)),
        "align_packed": (
            lambda: align_cuda.align_batch_packed(
                b2w_ts, nmw_ts, l_ts, TRUSEQ, L=seq_ts, tie_flag=True),
            lambda: align_cuda.align_batch_packed_plain(
                b2w_ts, nmw_ts, l_ts, TRUSEQ, L=seq_ts, tie_flag=True),
            int(lens_k3.sum()) * len(TRUSEQ) * DP_OPS_PER_CELL,
            (b2w_ts.numel() + nmw_ts.numel() + 10 * l_ts.numel()) * 4,
            "%d reads x %d bp, H=%d" % (CHUNK, seq_ts, len(TRUSEQ))),
        "align_unpacked": (
            lambda: align_unpacked_cuda.align_batch_unpacked(
                rna_b, rna_l, SMALL_RNA, tie_flag=True),
            lambda: align_batch(rna_b, rna_l, SMALL_RNA, tie_flag=True),
            int(rna_l.clamp(max=rna_b.shape[1]).sum()) * len(SMALL_RNA)
            * DP_OPS_PER_CELL,
            rna_b.numel() + 10 * 4 * rna_l.numel(),
            "%d reads x %d bp, H=%d" % (CHUNK, rna_b.shape[1],
                                        len(SMALL_RNA))),
        "align_unpacked_serial": (
            lambda: align_unpacked_cuda.align_batch_unpacked(
                sr_b, sr_l, h128, tie_flag=True),
            lambda: align_batch(sr_b, sr_l, h128, tie_flag=True),
            int(sr_l.clamp(max=sr_b.shape[1]).sum()) * len(h128)
            * DP_OPS_PER_CELL,
            sr_b.numel() + 10 * 4 * sr_l.numel(),
            "%d reads x %d bp, H=%d" % (sr_b.shape[0], sr_b.shape[1],
                                        len(h128))),
    }
    # K5/K5b: 2 bytes (K5b 1.25) read a counted base, the lengths, and the
    # histogram written once; the library call is one torch.bincount over
    # the same flat ids, precomputed
    n_valid = int(s_l.clamp(0, s_b.shape[1]).sum())
    fixed = 4 * s_l.numel() + 4 * s_b.shape[1] * stats_cuda.F
    flat = stats_cuda.flat_ids(stats_cuda.ascii_slots(s_b), s_q, s_l)
    minlength = s_b.shape[1] * stats_cuda.F
    shapes["stats_hist"] = (
        lambda: stats_cuda.stats_hist(s_b, s_q, s_l),
        lambda: stats_cuda.stats_hist_plain(s_b, s_q, s_l),
        n_valid * COUNT_OPS_PER_BASE, 2 * n_valid + fixed,
        "%d reads x %d bp (L=%d)" % (CHUNK, READ_LEN, s_b.shape[1]))
    shapes["stats_hist_b2"] = (
        lambda: stats_cuda.stats_hist_b2(s_b2, s_q, s_l),
        lambda: stats_cuda.stats_hist_b2_plain(s_b2, s_q, s_l),
        n_valid * COUNT_OPS_PER_BASE, n_valid // 4 + n_valid + fixed,
        "%d reads x %d bp (L=%d), 2-bit codes" % (CHUNK, READ_LEN,
                                                  s_b.shape[1]))
    # the tiled kernel on the 8192 x 301 batch of phase 3
    n301 = int(np.clip(l301_l, 0, 301).sum())
    l301 = [torch.from_numpy(a).to(dev) for a in (l301_b, l301_q, l301_l)]
    shapes["stats_hist_tiled"] = (
        lambda: stats_cuda.stats_hist(*l301),
        lambda: stats_cuda.stats_hist_plain(*l301),
        n301 * COUNT_OPS_PER_BASE,
        2 * n301 + 4 * 8192 + 4 * 301 * stats_cuda.F,
        "8192 reads x 301 (L=301)")
    library = {k: None for k in shapes}
    for k in ("stats_hist", "stats_hist_b2"):
        library[k] = cuda_ms(
            lambda: torch.bincount(flat, minlength=minlength), 10)
    flat301 = stats_cuda.flat_ids(stats_cuda.ascii_slots(l301[0]), l301[1],
                                  l301[2])
    library["stats_hist_tiled"] = cuda_ms(
        lambda: torch.bincount(flat301, minlength=301 * stats_cuda.F), 10)
    # P: its timed variant from the probe's own run, the plain version at
    # the same shape; its plane ops (one instruction each in its SASS)
    res_, case_, dpx_, h_, b_ = PROBE_TIMED
    timed = [r for r in p_results if (r["residence"], r["case"], r["dpx"],
                                      *r["plane_shape"]) == PROBE_TIMED]
    if not timed:
        fail("the probe's run did not reach its timed variant %s"
             % (PROBE_TIMED,))
    shapes["plane_probe"] = (
        None, lambda: plane_probe_plain(case_, h_, b_, TPU_K, TPU_U,
                                        device=dev),
        plane_ops(TPU_K, TPU_U) * h_ * b_, 4 * b_,
        "%s %s [%d x %d], K=%d, U=%d" % (res_, probe.variant_name(case_, dpx_),
                                         h_, b_, TPU_K, TPU_U))
    library["plane_probe"] = None
    # the reading beside the bound: each kernel's H (for P's reg rate)
    at_h = {"align_packed12": len(adapter), "align_packed": len(TRUSEQ),
            "align_unpacked": len(SMALL_RNA),
            "align_unpacked_serial": len(h128), "plane_probe": h_}
    ms, plain_ms, bound, old_bound, p_rate, dms = ({} for _ in range(6))
    for k, (fn, plain, ops, nbytes, shape) in shapes.items():
        ms[k] = timed[0]["ms"] if fn is None else cuda_ms(fn, 10)
        dms[k] = None if fn is None else device_ms(fn, 10, DEVICE_NAMES[k])
        plain_ms[k] = cuda_ms(plain, 1 if fn is None else 2)
        bound[k] = roofline(ops, nbytes, ISSUE_LANES * clock_hz)
        old_bound[k] = roofline(ops, nbytes, INT32_LANES * clock_hz)
        p_rate[k] = ops / rates["int32_at"].get(at_h.get(k),
                                                 rates["int32"]) * 1e3
        print("  %-21s %.3f ms (plain torch %.3f ms; library %s; bound "
              "%.4f ms by %s at the int32 issue rate and 3.35 TB/s; "
              "readings: int32 ops at P's best reg rate %.4f ms, "
              "assumed-peak bound %.4f ms by %s) at %s on %s"
              % (k, ms[k], plain_ms[k],
                 "n/a" if library[k] is None
                 else "torch.bincount %.3f ms" % library[k],
                 bound[k][0], bound[k][1], p_rate[k], old_bound[k][0],
                 old_bound[k][1], shape, card), flush=True)
    print("  device ms (torch.profiler, the kernel alone): %s on %s" % (
        ", ".join("%s %s" % (k, "n/a" if v is None else "%.4f" % v)
                  for k, v in dms.items()), card), flush=True)
    # K4 at path (c)'s shape: the headline lane's first chunk as ASCII
    # against the headline adapter, held against the plain version once
    hl = codec.parse(data[:record_cut(data, CHUNK)], filetype=codec.FASTQ_ONLY,
                     q_offset=33)
    hl_b = torch.from_numpy(hl.bases).to(dev)
    hl_l = torch.from_numpy(hl.lengths.astype(np.int32)).to(dev)
    k4_check("K4 headline lane 262144 ASCII", hl_b, hl_l, adapter)
    hl_ms = cuda_ms(lambda: align_unpacked_cuda.align_batch_unpacked(
        hl_b, hl_l, adapter, tie_flag=True), 10)
    hl_bound = roofline(
        int(hl_l.clamp(max=hl_b.shape[1]).sum()) * len(adapter)
        * DP_OPS_PER_CELL, hl_b.numel() + 10 * 4 * hl_l.numel(),
        ISSUE_LANES * clock_hz)
    print("  align_unpacked at path (c)'s shape: %.3f ms (bound %.4f ms by "
          "%s) at %d reads x %d bp, H=%d, (G, K) = %s on %s"
          % (hl_ms, hl_bound[0], hl_bound[1], hl_b.shape[0], hl_b.shape[1],
             len(adapter), align_unpacked_cuda.k4_pick(len(adapter)), card),
          flush=True)

    # 6. kernels
    print("[6 done] %.1f s in all" % (time.perf_counter() - t_main),
          flush=True)
    total = {k: sum(ln[k] for ln in launches.values()) for k in KERNELS}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": META[k][0],
         "replaces": META[k][1], "launches": total[k],
         "max_abs_err": errs[k], "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bound[k][0], "bound_by": bound[k][1],
         "library_ms": library[k], "assumed_bound_ms": old_bound[k][0],
         "p_rate_ms": p_rate[k], "smem_state_ms": None,
         "sass_instr_per_cell": cell_instr.get(k), "device_ms": dms.get(k)}
        for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2]))
    sys.exit(main())

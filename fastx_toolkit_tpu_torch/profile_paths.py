"""Where the time goes on the card: one profiled run of each main path.

Run from the repository root on a machine with a CUDA card:

    python -m fastx_toolkit_tpu_torch.profile_paths [--reads N]

It generates the seeded lanes of ``chip_smoke.py`` (``synth``), warms
each path up once on a small slice, then runs each path once over the
whole lane under ``torch.profiler`` (CPU and CUDA activities) and prints,
per path: the wall seconds, the card's busy milliseconds (the union of
the device intervals of every kernel and copy, so overlapping streams
count once), the busy share of the wall, and the device time by kernel
name.  The paths:

* ``headline``  — ``fastx_pipeline`` on the headline chain (line engine,
  K1 and K2), 1M x 100 bp;
* ``clipper``   — ``fastx_clipper -Q 33 -a TGGAATTCTCGGGTGCCAAGG -l 15 -c
  -v`` (K4), 1M x 50 bp small-RNA lane;
* ``truseq``    — ``fastx_pipeline`` on the headline chain with the 33-base
  TruSeq adapter (line engine, K3 and K2), 1M x 150 bp;
* ``classic``   — ``fastx_pipeline -v`` on the headline chain: the classic
  per-batch loop (K4), 1M x 100 bp;
* ``stats``     — ``fastx_quality_stats -Q 33`` on the headline lane with
  the ``device`` engine (the default on a card: parse, upload, K5).

Each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import synth
from .cli.common import CliContext
from .cli.tools import fastx_clipper, fastx_pipeline, fastx_quality_stats

HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


def _run(tool, argv, data):
    ctx = CliContext(prog="profile", stdin=io.BytesIO(data),
                     stdout=io.BytesIO(), stderr=io.StringIO(),
                     stdout_text=io.StringIO())
    if tool.tool_main(ctx, argv) != 0:
        raise RuntimeError("%s failed: %s" % (argv, ctx.stderr.getvalue()))


def _busy_ms(events):
    """Union of the device intervals, and device time by name."""
    spans, by_name = [], defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, by_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    n = args.reads
    lane = synth.synth_lane_bytes(n, 100, seed=42)
    paths = {
        "headline": (fastx_pipeline, ["-Q", "33", HEADLINE], lane),
        "clipper": (fastx_clipper,
                    ["-Q", "33", "-a", "TGGAATTCTCGGGTGCCAAGG", "-l", "15",
                     "-c", "-v"],
                    synth.synth_small_rna_lane_bytes(n, 50, seed=44)),
        "truseq": (fastx_pipeline,
                   ["-Q", "33", HEADLINE.replace("CTGTAGGCACCATCAAT",
                                                 TRUSEQ.decode())],
                   synth.synth_lane_bytes(n, 150, seed=43, adapter=TRUSEQ)),
        "classic": (fastx_pipeline, ["-v", "-Q", "33", HEADLINE], lane),
        "stats": (fastx_quality_stats, ["-Q", "33"], lane),
    }
    for name, (tool, argv, data) in paths.items():
        cut = data.find(b"\n@r%d\n" % min(n - 1, 20000)) + 1
        _run(tool, argv, data[:cut])  # warm-up: build, first launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _run(tool, argv, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, by_name = _busy_ms(prof.events())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print("%-8s %d reads: wall %.3f s (profiled), card busy %.2f ms = "
              "%.2f %% of the wall, on %s" % (name, n, wall, busy,
                                               100 * busy / 1e3 / wall, smi),
              flush=True)
        for k, ms in top:
            print("    %9.3f ms  %s" % (ms, k[:90]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

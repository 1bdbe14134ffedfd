"""Where the time goes on the card: one profiled run of each main path.

Run from the repository root on a machine with a CUDA card:

    python -m fastx_toolkit_tpu_torch.profile_paths [--reads N]
    python -m fastx_toolkit_tpu_torch.profile_paths --policy

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
  the ``device`` engine (``FASTX_STATS_PATH=device``: parse, upload,
  K5);
* ``collapse``  — ``fastx_collapser -Q 33`` with the ``device`` engine
  (``FASTX_COLLAPSE_PATH=device``: parse, upload, sort and segment sums,
  host merge) on the 1M-read collapse lane (``synth_collapse_lane_bytes``,
  seed 11);
* ``perread``   — ``fastq_quality_filter -Q 33 -q 20 -p 50`` with
  ``FASTX_LINEPATH=off`` (the classic path: parse, upload, transform) on
  the headline lane;
* ``barcode``   — ``fastx_barcode_splitter --bol --mismatches 1`` on the
  1M x 100 bp inline-barcode lane (``synth_barcode_lane_bytes``, 24
  six-base barcodes), its files in a temporary directory; besides the
  profile, the wall by the splitter's phases: framing
  (``split_records``), the fragment matrix (the rest of ``main_io``), the
  match (``_matcher``: upload, ``barcode_match``, copy back) and routing
  with writing (``_route_and_report``).

``--policy`` times the two engines of each dual-engine kind of
``engine/policy.py`` instead, in ten pairs (host then device in even
pairs, device then host in odd ones), each run over the whole lane
and its output held equal to its pair's: ``stats`` (``FASTX_STATS_PATH``)
on the headline lane, ``collapse`` (``FASTX_COLLAPSE_PATH``) on the
collapse lane, and ``per-read`` (``FASTX_LINEPATH=on``, the raw-line
path, against ``off``, the classic path on the card) for each of the six
per-read tools that have a raw-line path, with ``chip_smoke.py`` path
(f)'s options (``fastq_to_fasta`` without ``-r``) on the headline lane.  Per kind it prints every time, the
medians, the spreads and how many pairs each engine won, and one JSON
line.

Each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import synth
from .cli.common import CliContext
from .cli.tools import (
    fastq_masker,
    fastq_quality_filter,
    fastq_quality_trimmer,
    fastq_to_fasta,
    fastx_artifacts_filter,
    fastx_clipper,
    fastx_collapser,
    fastx_pipeline,
    fastx_quality_stats,
    fastx_trimmer,
)
from .scripts import barcode_splitter

HEADLINE = ("fastx_trimmer | fastq_quality_filter -q 20 -p 50 | "
            "fastq_quality_trimmer -t 20 | fastq_masker -q 20 | "
            "fastx_clipper -a CTGTAGGCACCATCAAT -l 5 -n | "
            "fastx_artifacts_filter")
TRUSEQ = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


POLICY_PAIRS = 10
# the six per-read tools with a raw-line path, with chip_smoke.py path
# (f)'s options (fastq_to_fasta without -r, which turns the path off)
PER_READ = (
    (fastx_trimmer, ["-Q", "33", "-l", "90", "-v"]),
    (fastq_quality_filter, ["-Q", "33", "-q", "20", "-p", "50", "-v"]),
    (fastq_quality_trimmer, ["-Q", "33", "-t", "20", "-v"]),
    (fastq_masker, ["-Q", "33", "-q", "20", "-v"]),
    (fastq_to_fasta, ["-Q", "33", "-n", "-v"]),
    (fastx_artifacts_filter, ["-Q", "33", "-v"]),
)


def _run(tool, argv, data, env=None):
    """One in-process run of ``tool`` with ``env`` set for its duration:
    its stdout bytes."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        ctx = CliContext(prog="profile", stdin=io.BytesIO(data),
                         stdout=io.BytesIO(), stderr=io.StringIO(),
                         stdout_text=io.StringIO())
        if tool.tool_main(ctx, argv) != 0:
            raise RuntimeError("%s failed: %s" % (argv,
                                                  ctx.stderr.getvalue()))
        return ctx.stdout.getvalue()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Splitter:
    """``fastx_barcode_splitter`` behind the CLIs' ``tool_main``."""

    @staticmethod
    def tool_main(ctx, argv):
        return barcode_splitter.main_io(argv, ctx.stdin, ctx.stdout_text,
                                        ctx.stderr)


class _PhaseClock:
    """Wall seconds inside the splitter's phase functions while active."""
    PHASES = ("split_records", "_matcher", "_route_and_report")

    def __enter__(self):
        self.secs = dict.fromkeys(self.PHASES, 0.0)
        self.saved = {n: getattr(barcode_splitter, n) for n in self.PHASES}

        def clocked(name, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.secs[name] += time.perf_counter() - t0
            return call

        for n, fn in self.saved.items():
            setattr(barcode_splitter, n, clocked(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(barcode_splitter, n, fn)


def _timed(tool, argv, data, env):
    t0 = time.perf_counter()
    out = _run(tool, argv, data, env)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def policy_pairs(name, tool, argv, data, engines, pairs, smi):
    """``pairs`` alternating timed runs of ``tool`` on its two engines
    (``engines``: ``{"host": env, "device": env}``), outputs held equal
    within each pair: the kind's line and its JSON record."""
    warm = data[:data.find(b"\n@r20000\n") + 1] or data
    for env in engines.values():
        _run(tool, argv, warm, env)  # builds, first launches
    secs = {"host": [], "device": []}
    for i in range(pairs):
        order = ("host", "device") if i % 2 == 0 else ("device", "host")
        outs = {}
        for eng in order:
            t, outs[eng] = _timed(tool, argv, data, engines[eng])
            secs[eng].append(t)
        if outs["host"] != outs["device"]:
            raise RuntimeError("%s: the engines' outputs differ" % name)
    wins = sum(h < d for h, d in zip(secs["host"], secs["device"]))
    rec = {"kind": name, "argv": argv, "pairs": pairs, "card": smi}
    for eng, ts in secs.items():
        rec[eng] = {"s": ts, "median_s": statistics.median(ts),
                    "min_s": min(ts), "max_s": max(ts)}
    rec["host_wins"] = wins
    print("%-40s host median %.3f s (%.3f-%.3f), device median %.3f s "
          "(%.3f-%.3f), host won %d of %d pairs, on %s" % (
              name, rec["host"]["median_s"], rec["host"]["min_s"],
              rec["host"]["max_s"], rec["device"]["median_s"],
              rec["device"]["min_s"], rec["device"]["max_s"], wins, pairs,
              smi), flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def policy(n, pairs, smi):
    """The engine policy's kinds timed on the card (see the module
    docstring)."""
    lane = synth.synth_lane_bytes(n, 100, seed=42)
    policy_pairs("stats fastx_quality_stats -Q 33", fastx_quality_stats,
                 ["-Q", "33"], lane,
                 {"host": {"FASTX_STATS_PATH": "host"},
                  "device": {"FASTX_STATS_PATH": "device"}}, pairs, smi)
    policy_pairs("collapse fastx_collapser -Q 33", fastx_collapser,
                 ["-Q", "33"], synth.synth_collapse_lane_bytes(n, seed=11),
                 {"host": {"FASTX_COLLAPSE_PATH": "host"},
                  "device": {"FASTX_COLLAPSE_PATH": "device"}}, pairs, smi)
    for tool, argv in PER_READ:
        policy_pairs("per-read " + tool.__name__.rsplit(".", 1)[1], tool,
                     argv, lane, {"host": {"FASTX_LINEPATH": "on"},
                                  "device": {"FASTX_LINEPATH": "off"}},
                     pairs, smi)


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
    ap.add_argument("--policy", action="store_true",
                    help="time the engine policy's kinds instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    n = args.reads
    if args.policy:
        policy(n, POLICY_PAIRS, smi)
        return 0
    lane = synth.synth_lane_bytes(n, 100, seed=42)
    tmp = tempfile.TemporaryDirectory()
    bc_lane, bcfile = synth.synth_barcode_lane_bytes(n, 100, bol=True)
    with open(os.path.join(tmp.name, "bc.txt"), "wb") as fh:
        fh.write(bcfile)
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
        "collapse": (fastx_collapser, ["-Q", "33"],
                     synth.synth_collapse_lane_bytes(n, seed=11)),
        "perread": (fastq_quality_filter,
                    ["-Q", "33", "-q", "20", "-p", "50"], lane),
        "barcode": (_Splitter,
                    ["--bcfile", os.path.join(tmp.name, "bc.txt"), "--bol",
                     "--mismatches", "1", "--prefix",
                     os.path.join(tmp.name, "bc_"), "--suffix", ".fq"],
                    bc_lane),
    }
    envs = {"stats": {"FASTX_STATS_PATH": "device"},
            "collapse": {"FASTX_COLLAPSE_PATH": "device"},
            "perread": {"FASTX_LINEPATH": "off"}}
    for name, (tool, argv, data) in paths.items():
        cut = data.find(b"\n@r%d\n" % min(n - 1, 20000)) + 1
        env = envs.get(name)
        _run(tool, argv, data[:cut], env)  # warm-up: build, first launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                _PhaseClock() as phases:
            t0 = time.perf_counter()
            _run(tool, argv, data, env)
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
        if tool is _Splitter:
            sec = phases.secs
            print("    wall by phase (profiled): framing %.3f s, fragment "
                  "matrix %.3f s, match %.3f s, routing and writing %.3f s"
                  % (sec["split_records"], wall - sum(sec.values()),
                     sec["_matcher"], sec["_route_and_report"]), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""fastx_pod_torch — launch one of the port's tools as N cooperating
worker processes with the multi-process environment wired up.

Counterpart of ``fastx_toolkit_tpu/cli/pod.py`` (``fastx_pod``), with the
same flags.  The multi-process execution model (see
``parallel/multihost``) is activated by environment variables so every
tool keeps its reference-identical flag surface; on several machines each
runs the same command with its own FASTX_TPU_PROCESS_ID.  This launcher
covers the one-machine case by spawning N local workers itself:

    fastx_pod_torch -n 4 [--cpu] [--coordinator HOST:PORT] -- \\
        fastx_quality_stats -i lane.fastq -o stats.txt

Each worker streams its own record-aligned byte range of the input;
per-read tools write FILE.shard-<k>-of-<n> outputs (in-order concat ==
single-process output), global tools (stats/collapser) write the merged
result from process 0 only, and -v reports print once with global
counters.

A bare tool name of the ``fastx-torch`` dispatcher (``cli/main.py``) runs
the port's tool (``python -m fastx_toolkit_tpu_torch.cli.main TOOL``);
any other command runs as given.  ``--cpu`` sets FASTX_TORCH_DEVICE=cpu
in the workers; without it worker k gets ``cuda:<k mod the card count>``
unless the caller set FASTX_TORCH_DEVICE, so on a machine with one card
every worker shares it (the merges run over gloo on the host, which
needs no card of its own).  When a worker fails, the launcher stops the
others rather than leave them waiting on a merge.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

USAGE = """usage: fastx_pod [-n N] [--cpu] [--coordinator HOST:PORT] -- TOOL [ARGS...]

Run TOOL as N cooperating worker processes (multi-host execution model).

   -n N                 = number of worker processes (default 2).
   --cpu                = force the CPU backend in the workers (testing).
   --pin-cores          = pin worker K to CPU core K via taskset
                          (single-machine scaling measurements).
   --coordinator H:P    = torch.distributed coordinator address
                          (default 127.0.0.1:19873).
   --                   = everything after this is the tool command line.
"""

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker_env(rank: int, n: int, coordinator: str, *, cpu: bool = False,
               n_cards: int = 0, env=None) -> dict:
    """The environment of worker ``rank`` of ``n``: the process group's
    three variables, shard-only mode cleared, the port on PYTHONPATH, and
    its device (``cpu`` with ``cpu``, else ``cuda:<rank mod n_cards>``
    unless FASTX_TORCH_DEVICE is set already or there is no card)."""
    env = dict(os.environ if env is None else env,
               FASTX_TPU_COORDINATOR=coordinator,
               FASTX_TPU_NUM_PROCESSES=str(n),
               FASTX_TPU_PROCESS_ID=str(rank))
    if cpu:
        env["FASTX_TORCH_DEVICE"] = "cpu"
    elif not env.get("FASTX_TORCH_DEVICE") and n_cards > 0:
        env["FASTX_TORCH_DEVICE"] = "cuda:%d" % (rank % n_cards)
    env.pop("FASTX_TPU_NUM_SHARDS", None)
    env.pop("FASTX_TPU_SHARD_ID", None)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    return env


def tool_command(tool_cmd: list) -> list:
    """A bare name of the port's dispatcher as the command that runs the
    port's tool; any other command unchanged."""
    from .main import TOOLS

    name = tool_cmd[0].removesuffix(".pl").removesuffix(".sh")
    if "/" not in tool_cmd[0] and name in TOOLS:
        return [sys.executable, "-m", "fastx_toolkit_tpu_torch.cli.main",
                *tool_cmd]
    return list(tool_cmd)


def wait_all(procs, poll_s: float = 0.05) -> int:
    """Wait for every worker; the first non-zero exit stops the others
    and is returned (0 when all succeed)."""
    status = 0
    live = list(procs)
    while live:
        for p in list(live):
            rc = p.poll()
            if rc is None:
                continue
            live.remove(p)
            if rc != 0 and status == 0:
                status = rc
                for q in live:
                    q.terminate()
        if live:
            time.sleep(poll_s)
    return status


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    n = 2
    cpu = False
    pin_cores = False
    coordinator = "127.0.0.1:19873"
    tool_cmd = None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-n":
            i += 1
            n = int(args[i])
        elif a == "--cpu":
            cpu = True
        elif a == "--pin-cores":
            pin_cores = True
        elif a == "--coordinator":
            i += 1
            coordinator = args[i]
        elif a == "--":
            tool_cmd = args[i + 1 :]
            break
        elif a in ("-h", "--help"):
            sys.stdout.write(USAGE)
            return 1
        else:
            sys.stderr.write("fastx_pod: unknown option '%s'\n" % a)
            sys.stdout.write(USAGE)
            return 1
        i += 1
    if not tool_cmd:
        sys.stdout.write(USAGE)
        return 1
    if n < 1:
        sys.stderr.write("fastx_pod: -n must be >= 1\n")
        return 1

    n_cards = 0
    if not cpu and not os.environ.get("FASTX_TORCH_DEVICE"):
        import torch

        n_cards = torch.cuda.device_count()
    cmd0 = tool_command(tool_cmd)
    procs = []
    try:
        for rank in range(n):
            env = worker_env(rank, n, coordinator, cpu=cpu, n_cards=n_cards)
            cmd = cmd0
            if pin_cores:
                ncpu = os.cpu_count() or 1
                cmd = ["taskset", "-c", str(rank % ncpu), *cmd0]
            procs.append(subprocess.Popen(cmd, env=env))
        return wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())

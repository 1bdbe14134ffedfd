"""Process-level CLI plumbing of the port.

Counterpart of ``fastx_toolkit_tpu/cli/common.py:205-338``.  The argument
parser, ``CliContext``, ``errx`` and the exit-status contract are the
reference's own (imported); this module replaces what pulls ``jax`` in
there: ``run_tool_main`` (the reference initialises jax's compile cache
and its multi-host process group) and ``OutputWriter`` (whose multi-host
shard roles import the reference's ``parallel`` package).  The port runs
one process; multi-GPU sharding is a later slice.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable

from fastx_toolkit_tpu.cli.common import (  # noqa: F401  (re-exported)
    PACKAGE_STRING,
    CliContext,
    CommonArgs,
    ExitWithStatus,
    errx,
    parse_cmdline,
)
from ..core import FastxError


class OutputWriter:
    """File/stdout writer with an optional gzip child, like the reference
    tools' open_output_compressor (fastx.c:214-248)."""

    def __init__(self, ctx: CliContext, common: CommonArgs):
        self.ctx = ctx
        self._gzip = None
        self._file = None
        filename = common.output_filename
        if common.compress:
            if filename == "-":
                self._gzip = subprocess.Popen(["gzip"], stdin=subprocess.PIPE,
                                              stdout=ctx.stdout)
            else:
                self._file = self._open(filename)
                self._gzip = subprocess.Popen(["gzip"], stdin=subprocess.PIPE,
                                              stdout=self._file)
            self.stream = self._gzip.stdin
        elif filename == "-":
            self.stream = ctx.stdout
        else:
            self._file = self._open(filename)
            self.stream = self._file

    def _open(self, filename):
        try:
            return open(filename, "wb")
        except OSError as e:
            print("%s: Failed to create output file (%s): %s"
                  % (self.ctx.prog, filename, e.strerror), file=self.ctx.stderr)
            raise ExitWithStatus(1)

    def write(self, data: bytes):
        self.stream.write(data)

    def close(self):
        if self._gzip is not None:
            self._gzip.stdin.close()
            self._gzip.wait()
        elif self.stream is not self.ctx.stdout:
            self.stream.close()
        if self._file is not None:
            self._file.close()


def run_tool_main(tool_main: Callable[[CliContext, list], int],
                  argv=None) -> int:
    """Run ``tool_main`` as a process: FastxError and ExitWithStatus map
    to exit codes as in the reference; a chain or input that a later port
    slice covers is reported as ``prog: not supported yet: ...`` with
    status 1."""
    # "python -m ...fastx_pipeline" names the module file: drop its .py
    ctx = CliContext(prog=os.path.splitext(os.path.basename(sys.argv[0]))[0])
    args = list(sys.argv[1:] if argv is None else argv)
    try:
        status = tool_main(ctx, args)
    except ExitWithStatus as e:
        status = e.status
    except FastxError as e:
        print("%s: %s" % (ctx.prog, e), file=ctx.stderr)
        status = e.status
    except NotImplementedError as e:
        print("%s: not supported yet: %s" % (ctx.prog, e), file=ctx.stderr)
        status = 1
    except BrokenPipeError:
        status = 1
    try:
        sys.stdout.flush()
    except BrokenPipeError:
        status = 1
    return status

"""Process-level CLI plumbing of the port.

Counterpart of ``fastx_toolkit_tpu/cli/common.py``.  The fastx_args
contract (FASTX-Toolkit's ``fastx_args.c``) is the reference's, copied
verbatim so that usage and error texts are identical:

* common flags ``-h -v -z -i -o -Q N`` prepended to each tool's options
  (option string "Q:zhvi:o:" + tool options);
* defaults: stdin/stdout, ASCII offset 33, report to stderr unless ``-o``
  was given, then stdout;
* ``-h`` prints the usage text and exits 1; unknown flags: getopt's
  "invalid option" to stderr, then "use '-h' for usage information." to
  stdout, exit 1;

plus ``errx``, ``c_atoi``/``c_strtoul`` and ``report_stream``.
``run_tool_main`` and ``OutputWriter`` are the single-process halves of
the reference's (which set up jax's compile cache and multi-host shard
roles): the port runs one process; multi-GPU sharding is a later slice.
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.errors import FastxError

PACKAGE_STRING = "FASTX Toolkit 0.0.14"


class ExitWithStatus(Exception):
    def __init__(self, status: int):
        self.status = status


@dataclass
class CliContext:
    """Execution context, injectable for in-process testing."""

    prog: str
    stdin: object = None  # binary readable
    stdout: object = None  # binary writable
    stderr: object = None  # text writable
    stdout_text: object = None  # text writable (reports to stdout)

    def __post_init__(self):
        if self.stdin is None:
            self.stdin = sys.stdin.buffer
        if self.stdout is None:
            self.stdout = sys.stdout.buffer
        if self.stderr is None:
            self.stderr = sys.stderr
        if self.stdout_text is None:
            self.stdout_text = sys.stdout


@dataclass
class CommonArgs:
    input_filename: str = "-"
    output_filename: str = "-"
    verbose: bool = False
    compress: bool = False
    q_offset: int = 33
    report_to_stdout: bool = False
    tool_args: dict = field(default_factory=dict)


def _atoi(s: str) -> int:
    """C atoi: optional sign then digits; parses the longest valid prefix,
    0 if none."""
    s = s.lstrip(" \t\n\v\f\r")
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j].replace("+", "", 1)) if s[0] == "+" else int(s[:j])


def c_atoi(s: str) -> int:
    return _atoi(s)


def c_strtoul(s: str) -> int:
    """strtoul(s, NULL, 10) as the tools use it (then stored in int)."""
    s = s.lstrip(" \t\n\v\f\r")
    neg = False
    i = 0
    if i < len(s) and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[i:j])
    if neg:
        v = (2**64 - v) % 2**64
    # tools assign the result to int; emulate the narrowing
    v &= 0xFFFFFFFF
    if v >= 2**31:
        v -= 2**32
    return v


def getopt_loop(ctx: CliContext, argv, optstring: str):
    """A glibc-flavored getopt: yields (optchar, optarg); on errors prints
    glibc's message to stderr and yields ('?', None)."""
    takes_arg = {}
    i = 0
    while i < len(optstring):
        c = optstring[i]
        has = i + 1 < len(optstring) and optstring[i + 1] == ":"
        takes_arg[c] = has
        i += 2 if has else 1

    args = list(argv)
    pos = 0
    while pos < len(args):
        tok = args[pos]
        if tok == "--":
            return
        if not tok.startswith("-") or tok == "-":
            pos += 1  # GNU getopt permutes; our tools ignore operands
            continue
        ci = 1
        while ci < len(tok):
            c = tok[ci]
            if c not in takes_arg:
                print("%s: invalid option -- '%s'" % (ctx.prog, c), file=ctx.stderr)
                yield "?", None
                ci += 1
                continue
            if takes_arg[c]:
                if ci + 1 < len(tok):
                    yield c, tok[ci + 1 :]
                elif pos + 1 < len(args):
                    pos += 1
                    yield c, args[pos]
                else:
                    print(
                        "%s: option requires an argument -- '%s'" % (ctx.prog, c),
                        file=ctx.stderr,
                    )
                    yield "?", None
                ci = len(tok)
            else:
                yield c, None
                ci += 1
        pos += 1


def parse_cmdline(
    ctx: CliContext,
    argv,
    tool_options: str,
    tool_cb: Optional[Callable[[CommonArgs, str, Optional[str]], None]],
    usage: str,
) -> CommonArgs:
    """fastx_parse_cmdline (fastx_args.c:76-143)."""
    common = CommonArgs()
    tool_chars = set(tool_options.replace(":", ""))
    for opt, arg in getopt_loop(ctx, argv, "Q:zhvi:o:" + tool_options):
        if opt in tool_chars:
            tool_cb(common, opt, arg)
            continue
        if opt == "h":
            ctx.stdout_text.write(usage)
            raise ExitWithStatus(1)
        elif opt == "v":
            common.verbose = True
        elif opt == "z":
            common.compress = True
        elif opt == "i":
            common.input_filename = arg
        elif opt == "o":
            common.output_filename = arg
            common.report_to_stdout = True
        elif opt == "Q":
            common.q_offset = c_atoi(arg)
        else:
            ctx.stdout_text.write("use '-h' for usage information.\n")
            raise ExitWithStatus(1)
    return common


def errx(ctx: CliContext, message: str) -> "NoReturn":  # noqa: F821
    print("%s: %s" % (ctx.prog, message), file=ctx.stderr)
    raise ExitWithStatus(1)


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
    to exit codes as in the reference."""
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
    except BrokenPipeError:
        status = 1
    try:
        sys.stdout.flush()
    except BrokenPipeError:
        status = 1
    return status


def report_stream(ctx: CliContext, common: CommonArgs):
    """Where ``-v`` reports go: stdout when ``-o`` was given, else
    stderr (one process, so always this process's own)."""
    return ctx.stdout_text if common.report_to_stdout else ctx.stderr

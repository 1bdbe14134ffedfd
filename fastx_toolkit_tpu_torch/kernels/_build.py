"""Build and load the port's CUDA kernels.

The ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into two shared
libraries with a plain C interface, loaded with ctypes: the kernels of
the CLIs' paths (:data:`SOURCES`, :func:`library`) and the plane-op
probe (:data:`PROBE_SOURCES`, :func:`probe_library`), whose many
template instantiations no CLI should wait for.  Each library lands in
``fastx_toolkit_tpu_torch/_build/<hash>/``, keyed on its sources' and
the flags' hash, and is built at first use: importing this module
compiles nothing.  The compiler's output (``-Xptxas -v``: registers,
spills) is kept beside it in ``build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("align_packed.cu", "align_unpacked.cu", "packed_counts.cu",
           "stats_hist.cu")
PROBE_SOURCES = ("plane_probe.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libfastx_torch_kernels.so"
PROBE_LIB_NAME = "libfastx_torch_probe.so"

_lock = threading.Lock()
_lib = None
_probe_lib = None


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build_key(sources=SOURCES) -> str:
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(sources=SOURCES, lib_name=LIB_NAME) -> str:
    """Compile ``sources`` into ``lib_name`` unless an identical build
    exists; returns its path.  Raises RuntimeError with the compiler's
    output on failure."""
    out_dir = os.path.join(BUILD_DIR, build_key(sources))
    so = os.path.join(out_dir, lib_name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR)
    try:
        procs = []
        for name in sources:
            obj = os.path.join(tmp, name + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", os.path.join(SRC_DIR, name),
                   "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log = []
        failed = []
        for name, _obj, p in procs:
            text = p.communicate()[0].decode(errors="replace")
            log.append("== %s ==\n%s" % (name, text))
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (", ".join(failed), "\n".join(log)))
        link = subprocess.run(
            [exe, "-shared", "-o", os.path.join(tmp, lib_name),
             *[obj for _n, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        with open(os.path.join(tmp, "build.log"), "w") as fh:
            fh.write("\n".join(log))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not os.path.exists(so):
                raise
        else:
            tmp = None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            cp = ctypes.c_char_p
            lib.fx_align_packed.argtypes = [vp, vp, vp, cp, ci, ci, ci, ci,
                                            vp, vp]
            lib.fx_align_packed.restype = ci
            lib.fx_align_unpacked.argtypes = [vp, vp, cp, cp, ci, ci, ci, ci,
                                              ci, vp, vp]
            lib.fx_align_unpacked.restype = ci
            lib.fx_align_unpacked_pick.argtypes = [ci, ci, ci]
            lib.fx_align_unpacked_pick.restype = ci
            lib.fx_align_unpacked_serial.argtypes = [vp, vp, vp, ci, ci, ci,
                                                     ci, vp, vp, vp]
            lib.fx_align_unpacked_serial.restype = ci
            lib.fx_packed_counts.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
            lib.fx_packed_counts.restype = ci
            lib.fx_stats_hist.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp,
                                          vp]
            lib.fx_stats_hist.restype = ci
            lib.fx_stats_hist_plan.argtypes = [ci, ci, ci, ci,
                                               ctypes.POINTER(ci)]
            lib.fx_stats_hist_plan.restype = ci
            _lib = lib
    return _lib


def probe_library() -> ctypes.CDLL:
    """The loaded probe library (built on first call)."""
    global _probe_lib
    with _lock:
        if _probe_lib is None:
            lib = ctypes.CDLL(build(PROBE_SOURCES, PROBE_LIB_NAME))
            lib.fx_plane_probe.argtypes = ([ctypes.c_int] * 9
                                           + [ctypes.c_void_p] * 2)
            lib.fx_plane_probe.restype = ctypes.c_int
            _probe_lib = lib
    return _probe_lib


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, status))

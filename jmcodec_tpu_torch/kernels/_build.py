"""Build the port's CUDA kernels from the sources in this checkout.

nvcc compiles every csrc/*.cu (with the csrc/*.cuh they include) for
sm_90a (Hopper), one process per source and all at once, and links the
objects into one shared library with a plain C interface (loaded with
ctypes by the wrappers), under the package's build/ directory. It builds on first use and again whenever a
source is newer than the library; it uses no sources from outside the
repository.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(_BUILD, "libjmx_cuda_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
# nvcc's stderr from the last build in this process (ptxas register, shared
# memory and spill counts per kernel); empty if the library was up to date
last_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _finish(what: str, proc) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{out}{err}")
    return err


def build(force: bool = False) -> str:
    """Compile the kernels if needed; returns the library's path."""
    global last_log
    srcs = sorted(glob.glob(os.path.join(_SRC, "*.cu")))
    headers = glob.glob(os.path.join(_SRC, "*.cuh"))
    with _lock:
        if (not force and os.path.exists(LIB) and all(
                os.path.getmtime(LIB) >= os.path.getmtime(s)
                for s in srcs + headers)):
            return LIB
        os.makedirs(_BUILD, exist_ok=True)
        nvcc = _nvcc()
        run = lambda args: subprocess.Popen(
            [nvcc, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        tag = os.getpid()
        objs = [os.path.join(_BUILD, f"{os.path.basename(s)}.{tag}.o")
                for s in srcs]
        procs = [run([*CFLAGS, "-c", "-o", o, s]) for s, o in zip(srcs, objs)]
        try:
            log = "".join([_finish(os.path.basename(s), p)
                           for s, p in zip(srcs, procs)])
            tmp = f"{LIB}.{tag}.tmp"
            log += _finish("link", run([*ARCH, "-shared", "-o", tmp, *objs]))
            os.replace(tmp, LIB)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        last_log = log
        return LIB

"""Builds the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``bitmagic_tpu_torch/_build/``.  All missing
libraries build at once, one ``nvcc`` per source, started together.  A
library's file name carries a hash of its sources and flags, so an edited
source never loads a stale build.  A failed build raises; nothing falls
back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), os.pardir, "_build")
BUILD_DIR = os.path.normpath(BUILD_DIR)
SOURCES = ("block_counts.cu", "count_op.cu", "logical_op_digest.cu",
           "agg_sub.cu", "pipeline_counts.cu", "scan_eq.cu", "gap_rows.cu",
           "sv_planes.cu", "rs_select.cu", "sv_descent.cu",
           "shift_chain.cu")
HEADERS = ("bm_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per built source
build_log: dict[str, str] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("bitmagic_tpu_torch: nvcc not found (PATH or "
                       "$CUDA_HOME/bin); the CUDA kernels cannot be built")


def library_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (src, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_all() -> None:
    """Compile every source whose library is missing, all in parallel."""
    todo = [s for s in SOURCES if not os.path.exists(library_path(s))]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    try:
        for src in todo:
            out = library_path(src)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, src)]
            procs.append((src, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, out, p in procs:
            log, _ = p.communicate()
            build_log[src] = log
            if p.returncode != 0:
                failed.append(f"{src} (nvcc exit {p.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("bitmagic_tpu_torch: kernel build failed:\n"
                           + "\n".join(failed))


def load(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            build_all()
            lib = _libs[src] = ctypes.CDLL(library_path(src))
        return lib

"""Build the package's CUDA kernels with nvcc and load them through ctypes.

Every `kernels/csrc/*.cu` source is compiled by its own nvcc process, all
started together, and the objects are linked into one shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <objs>/<source>.o csrc/<source>.cu    (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libraft_kernels_<hash>.so <objs>/*.o

on first use, into `raft_optical_flow_tpu_torch/_build/` (git-ignored). The
file name carries a hash of the sources and flags, so a changed source builds
anew and an unchanged one is reused. No PyTorch headers are compiled: the C
functions take raw device pointers, ints and a stream, and return
`cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # time of the build this process ran, if any
build_log: str = ""  # nvcc's output of that build (ptxas register counts)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libraft_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for their hash exists; return its path."""
    global build_seconds, build_log
    lib = library_path()
    if lib.exists():
        return lib
    obj_dir = lib.with_suffix(f".{os.getpid()}.objs")
    obj_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *sorted(str(o) for o in obj_dir.glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib

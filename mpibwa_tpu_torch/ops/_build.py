"""Build and load the port's hand-written CUDA sources (csrc/*.cu).

Each source compiles on first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, keyed by a hash of the source and of the headers beside it
(csrc/*.cuh) so an edited kernel rebuilds. ``load_all`` starts one nvcc
per source at once. Nothing here runs at import time: the package imports on machines without
nvcc or a GPU, and only a launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict = {}
# nvcc's -Xptxas -v report (registers, spills, shared memory) per source
build_logs: dict = {}
_entries: dict = {}  # the bound C entry points by (kernel, symbol)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build from "
                           "source on first use and need the CUDA toolkit")
    return path


def _paths(name: str) -> "tuple[str, str]":
    """(source, library) of a kernel; the library's name carries a hash of
    the source and of every header it may include."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_nvcc(src: str, so: str) -> "tuple[subprocess.Popen, str]":
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + ARCH_FLAGS
           + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-o", tmp, src])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), tmp


def _finish_nvcc(name: str, src: str, so: str, proc, tmp: str) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{err}")
    build_logs[name] = err
    os.replace(tmp, so)  # atomic: concurrent builds never see half


def load_all(names) -> None:
    """Build the missing libraries of several kernels side by side (one
    nvcc process each, all started together), then load them."""
    with _lock:
        jobs = []
        for name in names:
            src, so = _paths(name)
            if name not in _libs and not os.path.exists(so):
                jobs.append((name, src, so) + _start_nvcc(src, so))
        failed = []
        for job in jobs:  # wait for every compiler before raising
            try:
                _finish_nvcc(*job)
            except RuntimeError as e:
                failed.append(e)
        if failed:
            raise failed[0]
    for name in names:
        load(name)


def entry(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of kernel ``name`` with its argument types
    and an int result: built, loaded and bound on first use, then cached."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def launch_on(dev, fn, *args) -> int:
    """fn(*args, stream) on device dev's current stream; enters dev's
    context only when dev is not the current device already."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src, so = _paths(name)
        if not os.path.exists(so):
            _finish_nvcc(name, src, so, *_start_nvcc(src, so))
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib

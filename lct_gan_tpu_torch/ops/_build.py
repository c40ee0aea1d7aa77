"""Build-at-first-use of the port's CUDA kernels, and the ctypes glue that
calls them.

Each `lct_gan_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for sm_90a
into its own shared library with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). All sources
build in parallel, one nvcc process each. Libraries go to `build/` at the
repository root (ignored by git), under a name that carries a hash of every
file in `csrc/`: a change to any source or header rebuilds, an unchanged
tree reuses what is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict

import torch

__all__ = ["load_library", "build_all", "kernel_function", "raise_on_error",
           "f32_operand", "CSRC_DIR", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on the machine with the card")


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _sources():
    return sorted(n[:-3] for n in os.listdir(CSRC_DIR) if n.endswith(".cu"))


def build_all(verbose: bool = False) -> float:
    """Build (if needed) and load every csrc/*.cu library. Returns the
    seconds spent; raises with nvcc's stderr when a build fails."""
    with _lock:
        t0 = time.perf_counter()
        names = [n for n in _sources() if n not in _libs]
        if not names:
            return 0.0
        tag = _source_hash()
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {n: os.path.join(BUILD_DIR, f"lib{n}-{tag}.so") for n in names}
        procs = {}
        for n in names:
            if os.path.isfile(paths[n]):
                continue
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{n}.cu "
                              f"(rc={proc.returncode}):\n{err}{out}")
                continue
            if verbose and (err or out):
                print(f"[nvcc csrc/{n}.cu]\n{err}{out}", file=sys.stderr,
                      flush=True)
            os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            _libs[n] = ctypes.CDLL(paths[n])
        return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first if
    this process has not loaded them yet."""
    if name not in _libs:
        build_all()
    return _libs[name]


def kernel_function(lib_name: str, fn_name: str, argtypes):
    """A C entry point of csrc/<lib_name>.cu with its argtypes declared
    (ctypes.c_void_p for every pointer and the stream, or ctypes would pass
    them as 32-bit ints)."""
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def raise_on_error(err: int, lib_name: str, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err == 0:
        return
    fn = load_library(lib_name).lct_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")


def f32_operand(name: str, t, shape, device):
    """`t` as a contiguous float32 tensor of `shape` on `device`, or raise."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got one on {t.device}")
    return t.contiguous()

"""Build-at-first-use of the port's CUDA kernels, and the ctypes glue that
calls them.

Each `lct_gan_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for sm_90a
into its own shared library with a plain C interface, loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). Libraries go
to `build/` at the repository root (ignored by git), under a name that
carries a hash of every file in `csrc/`: a change to any source or header
rebuilds, an unchanged tree reuses what is there.

One set of libraries a kernel width CK (`ops/library.py::KERNEL_WIDTHS`:
16, 32, 64, 128, 256, 512), which every bottleneck width whose padded
layout needs it shares (`ops/padding.py::kernel_width`; the true width, the
heads and the score scale are arguments of each launch): CK = 64, the
default, builds every source as it always has (`lib<name>-<hash>.so`); any
other CK builds with -DLCT_C=<CK> into `lib<name>-c<CK>-<hash>.so` the
forward sources (`FORWARD_SOURCES`) at its first use, and the FTF
backward's (`BACKWARD_SOURCES`) at its first backward (at
`BACKWARD_WIDTHS`: every kernel width, 512 included), so serving alone
never builds the backward. A width past 512 has no libraries and is
refused by name. All sources of all the widths asked for build in one
parallel batch, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

import torch

__all__ = ["load_library", "build_all", "kernel_function", "raise_on_error",
           "f32_operand", "build_command", "library_path", "library_sources",
           "CSRC_DIR", "BUILD_DIR", "DEFAULT_C", "FORWARD_SOURCES",
           "BACKWARD_SOURCES", "BUILD_LOGS", "BUILD_SECONDS", "ptxas_usage"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
DEFAULT_C = 64
# The sources the serving path launches: every width builds these.
FORWARD_SOURCES = ("banded", "ftf", "mhsa")
# The training path's own: a width other than 64 builds it at its first
# backward.
BACKWARD_SOURCES = ("ftf_bwd",)

_lock = threading.Lock()
_libs: Dict[Tuple[str, int], ctypes.CDLL] = {}
# nvcc's output of each verbose build of this process, by (source, width).
BUILD_LOGS: Dict[Tuple[str, int], str] = {}
# Seconds from the start of its batch to the end of each nvcc process of
# this process's builds, by (source, width).
BUILD_SECONDS: Dict[Tuple[str, int], float] = {}


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


def library_sources(C: int = DEFAULT_C, backward: bool = False) -> List[str]:
    """The csrc/*.cu sources of kernel width C's libraries: all of them at
    the default width, the forward ones at any other, with `backward` also
    the FTF backward's (raises at a width it is not built for)."""
    from lct_gan_tpu_torch.ops.library import BACKWARD_WIDTHS, KERNEL_WIDTHS

    if C not in KERNEL_WIDTHS:
        raise ValueError(f"no CUDA libraries for kernel width C={C}: they "
                         f"are built for {KERNEL_WIDTHS}")
    if backward and C not in BACKWARD_WIDTHS:
        raise ValueError(f"no FTF backward library (csrc/ftf_bwd.cu) for "
                         f"kernel width C={C}: it is built for "
                         f"{BACKWARD_WIDTHS}")
    names = _sources()
    wanted = FORWARD_SOURCES + (BACKWARD_SOURCES if backward else ())
    return names if C == DEFAULT_C else [n for n in names if n in wanted]


def library_path(name: str, C: int, tag: str) -> str:
    """Where csrc/<name>.cu's library of kernel width C lives under `tag`
    (the hash of csrc/ and the flags)."""
    width = "" if C == DEFAULT_C else f"-c{C}"
    return os.path.join(BUILD_DIR, f"lib{name}{width}-{tag}.so")


def build_command(name: str, C: int, out: str, nvcc: str = "nvcc",
                  verbose: bool = False) -> List[str]:
    """The nvcc command that builds csrc/<name>.cu for kernel width C into
    `out`: the default width's command is the one it has always been, any
    other adds -DLCT_C=<C>."""
    width = [] if C == DEFAULT_C else [f"-DLCT_C={C}"]
    return [nvcc, *NVCC_FLAGS, *width, "-I", CSRC_DIR,
            *(["-Xptxas", "-v"] if verbose else []),
            "-o", out, os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(verbose: bool = False,
              widths: Iterable[int] = (DEFAULT_C,),
              backward=False, nice: int = 0) -> float:
    """Build (if needed) and load the libraries of every kernel width in
    `widths` (default: 64's, every csrc/*.cu) and the FTF backward's of
    `backward`'s widths (True: every width in `widths`; a tuple of widths),
    all in one parallel batch. Returns the seconds spent; raises with nvcc's
    stderr when a build fails, and by name for a backward width it is not
    built for. With `verbose` nvcc reports each kernel's registers and
    spills (-Xptxas -v): printed to stderr and kept in
    BUILD_LOGS[(name, width)]; each nvcc process's seconds are kept in
    BUILD_SECONDS[(name, width)]. `nice` > 0 runs the nvcc processes at that
    niceness (a build in a background thread beside running work: another
    thread that needs a library it builds waits for it here)."""
    widths = tuple(dict.fromkeys(widths))
    bwd = set(widths if backward is True else backward or ())
    with _lock:
        t0 = time.perf_counter()
        todo = [(n, C) for C in dict.fromkeys(widths + tuple(sorted(bwd)))
                for n in library_sources(C, C in bwd) if (n, C) not in _libs]
        if not todo:
            return 0.0
        tag = _source_hash()
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {k: library_path(*k, tag) for k in todo}
        procs = {}
        for k in todo:
            if os.path.isfile(paths[k]):
                continue
            tmp = f"{paths[k]}.{os.getpid()}.tmp"
            cmd = build_command(*k, tmp, _nvcc(), verbose)
            if nice > 0:
                cmd = ["nice", "-n", str(nice), *cmd]
            procs[k] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        def finish(k):  # in a thread a process: each end is its own
            out, err = procs[k][1].communicate()
            BUILD_SECONDS[k] = time.perf_counter() - t0
            return out, err

        with ThreadPoolExecutor(max(1, len(procs))) as pool:
            ends = dict(zip(procs, pool.map(finish, procs)))
        errors = []
        for (n, C), (tmp, proc) in procs.items():
            out, err = ends[(n, C)]
            what = f"csrc/{n}.cu" + ("" if C == DEFAULT_C else f" (C={C})")
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {what} "
                              f"(rc={proc.returncode}):\n{err}{out}")
                continue
            if verbose and (err or out):
                BUILD_LOGS[(n, C)] = err + out
                print(f"[nvcc {what}]\n{err}{out}", file=sys.stderr,
                      flush=True)
            os.replace(tmp, paths[(n, C)])
        if errors:
            raise RuntimeError("\n".join(errors))
        for k in todo:
            _libs[k] = ctypes.CDLL(paths[k])
        return time.perf_counter() - t0


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """{kernel: {"registers", "spill_stores", "spill_loads", "smem"}} of
    every entry function in nvcc's -Xptxas -v output `log` (mangled names;
    smem: the bytes of static shared memory, where ptxas reports them)."""
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                usage[name]["smem"] = int(m.group(1))
    return {k: v for k, v in usage.items() if "registers" in v}


def load_library(name: str, C: int = DEFAULT_C) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu at kernel width C, building
    that width's sources first if this process has not loaded them yet (the
    forward ones, and the backward's when `name` is one of them)."""
    if (name, C) not in _libs:
        build_all(widths=(C,), backward=name in BACKWARD_SOURCES)
    return _libs[(name, C)]


def kernel_function(lib_name: str, fn_name: str, argtypes,
                    C: int = DEFAULT_C):
    """A C entry point of csrc/<lib_name>.cu's library of kernel width C
    with its argtypes declared (ctypes.c_void_p for every pointer and the
    stream, ctypes.c_float for a float, or ctypes would pass them as
    32-bit ints)."""
    fn = getattr(load_library(lib_name, C), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def raise_on_error(err: int, lib_name: str, what: str,
                   C: int = DEFAULT_C) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err == 0:
        return
    fn = load_library(lib_name, C).lct_error_string
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

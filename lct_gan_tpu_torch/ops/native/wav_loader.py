"""ctypes binding for the native wav decode + downmix + resample library
(the counterpart of `lct_gan_tpu/ops/native/wav_loader.py` and its
`build.sh`).

`wav_io.cc` is built with g++ at first use into `build/` at the repository
root (ignored by git), under a name that carries a hash of the source, the
flags and the host's CPU (`-march=native` code may not run on another
one): a change to any of them rebuilds, an unchanged tree on the same host
reuses what is there. `build_library` raises with g++'s output when the
build fails. The decoder then warns once with that output and returns None
for every file, as the JAX package's binding does, so
`data/audio_io.py::load_mono_wave` reads with numpy; g++ is not run again
in that process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

__all__ = ["build_library", "load_mono_wave_native", "CXX_FLAGS", "SOURCE"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "wav_io.cc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))), "build")
# The JAX package's build.sh flags: -ffast-math lets the FIR reductions in
# ResamplePoly vectorize (audio payloads are finite). The object is compiled
# with them and linked with -shared alone: g++ links crtfastmath.o into a
# library linked with -ffast-math, whose constructor turns on flush-to-zero
# in the loading process (every later float op on its CPU, numpy's and
# torch's included); compiled this way the decoder's code is the same and
# the process's float mode is left alone.
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None   # set once a build failed here


def _cpu() -> str:
    """The host's CPU model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name",
                                                      "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:   # not Linux: the machine type alone
        return platform.machine() + platform.processor()


def _tag() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu().encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build_library(compiler: str = "g++", build_dir: str = BUILD_DIR) -> str:
    """Build wav_io.cc (unless a library of this source and these flags is
    there) and return its path. Raises RuntimeError with the compiler's
    output when the build fails."""
    path = os.path.join(build_dir, f"libwavio-{_tag()}.so")
    if os.path.isfile(path):
        return path
    exe = shutil.which(compiler)
    if exe is None:
        raise RuntimeError(f"{compiler} not found: the native wav decoder "
                           "is built with a C++ compiler at first use")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        for cmd in ([exe, *CXX_FLAGS, "-c", "-o", f"{tmp}.o", SOURCE],
                    [exe, "-shared", "-o", tmp, f"{tmp}.o"]):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{compiler} failed to build {SOURCE} "
                    f"(rc={proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, path)
    finally:
        for leftover in (f"{tmp}.o", tmp):
            if os.path.exists(leftover):
                os.remove(leftover)
    return path


def _get_lib() -> Optional[ctypes.CDLL]:
    """The library, or None when it could not be built in this process.
    The first failure warns with the compiler's output; later calls return
    None without running it again."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                path = build_library(build_dir=BUILD_DIR)
            # No compiler, a failed or timed-out compile, or a build
            # directory it cannot write.
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _build_error = str(e)
                warnings.warn("native wav decoder unavailable, decoding with "
                              f"numpy: {e}", RuntimeWarning, stacklevel=2)
                return None
            lib = ctypes.CDLL(path)
            lib.lct_load_mono_wave.restype = ctypes.c_long
            lib.lct_load_mono_wave.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.lct_copy_samples.restype = None
            lib.lct_copy_samples.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long]
            _lib = lib
        return _lib


def load_mono_wave_native(path: str, target_sr: int = 0
                          ) -> Optional[Tuple[np.ndarray, int]]:
    """Decode, downmix to mono and resample to `target_sr` (0: keep the
    file's rate) natively: ([T] float32, sample rate), or None when the
    native parser rejects the file or the library could not be built (the
    caller then reads it with numpy, which raises on a malformed file)."""
    lib = _get_lib()
    if lib is None:
        return None
    out_sr = ctypes.c_int(0)
    # The samples stay in a thread-local buffer of the library between the
    # two calls, so both run on this thread.
    n = lib.lct_load_mono_wave(os.fsencode(path), int(target_sr),
                               ctypes.byref(out_sr))
    if n < 0:
        return None
    buf = np.empty(int(n), dtype=np.float32)
    lib.lct_copy_samples(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
    return buf, int(out_sr.value)

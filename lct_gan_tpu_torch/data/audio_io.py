"""Wav read/write, header-only length probe, resampling and scp lists
(copies of `lct_gan_tpu/data/audio_io.py:39-236` and
`lct_gan_tpu/data/dataset.py:23-33`).

`load_mono_wave` decodes through the native C++ library
(`ops/native/wav_loader.py`), as the JAX package does wherever that library
builds; a file its parser rejects is read with numpy
(`load_mono_wave_numpy`, the plain version), which raises on a malformed
file. Integer PCM is scaled to [-1, 1) by 1 / 2^(bits-1), as torchaudio
does.
"""

from __future__ import annotations

import math
import os
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["read_wav", "wav_num_samples", "write_wav", "resample",
           "load_mono_wave", "load_mono_wave_numpy", "read_scp"]

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (samples [C, T] float32 in [-1, 1], sample_rate).
    PCM 8/16/24/32-bit and IEEE float 32/64; chunk-order agnostic."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != _RIFF or header[8:12] != _WAVE:
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        fmt_code = channels = sample_rate = bits = data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == _FMT:
                fmt = f.read(csize)
                (fmt_code, channels, sample_rate, _byte_rate, _block_align,
                 bits) = struct.unpack("<HHIIHH", fmt[:16])
                if fmt_code == _WAVE_FORMAT_EXTENSIBLE and csize >= 40:
                    fmt_code = struct.unpack("<H", fmt[24:26])[0]
            elif cid == _DATA:
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
                continue
            if csize & 1:
                f.seek(1, os.SEEK_CUR)
        if fmt_code is None or data is None:
            raise ValueError(f"Missing fmt/data chunk in wav: {path}")

    if fmt_code == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(
                np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) -
                 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            n = len(raw) // 3
            raw = raw[:n * 3].reshape(n, 3)
            val = (raw[:, 0].astype(np.int32) |
                   (raw[:, 1].astype(np.int32) << 8) |
                   (raw[:, 2].astype(np.int32) << 16))
            val = np.where(val & 0x800000, val - 0x1000000, val)
            x = val.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}: {path}")
    elif fmt_code == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"Unsupported float bit depth {bits}: {path}")
    else:
        raise ValueError(f"Unsupported wav format 0x{fmt_code:04x}: {path}")
    n_frames = len(x) // channels
    return x[:n_frames * channels].reshape(n_frames, channels).T, sample_rate


def wav_num_samples(path: str,
                    target_sr: Optional[int] = None) -> Tuple[int, int]:
    """Header-only length probe: (n_frames, sample_rate) without reading
    the data payload. With target_sr, n_frames is the post-resample frame
    count (scipy resample_poly's ceil). Drives batch_iterator's
    sort_by_length bucketing."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != _RIFF or header[8:12] != _WAVE:
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        channels = sample_rate = bits = data_size = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == _FMT:
                fmt = f.read(csize)
                (_fmt_code, channels, sample_rate, _br, _ba,
                 bits) = struct.unpack("<HHIIHH", fmt[:16])
                if csize & 1:
                    f.seek(1, os.SEEK_CUR)
            elif cid == _DATA:
                data_size = csize
                if channels is not None:
                    break  # fmt already seen; the payload is not needed
                f.seek(csize + (csize & 1), os.SEEK_CUR)
            else:
                f.seek(csize + (csize & 1), os.SEEK_CUR)
    if channels is None or data_size is None:
        raise ValueError(f"Missing fmt/data chunk in wav: {path}")
    n = data_size // ((bits // 8) * channels)
    if target_sr is not None and target_sr != sample_rate:
        g = math.gcd(int(target_sr), int(sample_rate))
        up, down = target_sr // g, sample_rate // g
        n = -(-(n * up) // down)  # ceil, matching resample_poly
        return n, target_sr
    return n, sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """Write float samples ([T] or [C, T], range [-1, 1]) as PCM16 (or
    float32 with bits=32) wav."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    C, T = x.shape
    inter = x.T.reshape(-1)
    if bits == 16:
        pcm = np.clip(np.round(inter * 32768.0), -32768, 32767).astype("<i2")
        payload = pcm.tobytes()
    elif bits == 32:
        payload = inter.astype("<f4").tobytes()
    else:
        raise ValueError(f"Unsupported write bit depth: {bits}")
    fmt_code = _WAVE_FORMAT_PCM if bits == 16 else _WAVE_FORMAT_IEEE_FLOAT
    block_align = C * bits // 8
    byte_rate = sample_rate * block_align
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", _RIFF, 36 + len(payload), _WAVE))
        f.write(struct.pack("<4sIHHIIHH", _FMT, 16, fmt_code, C,
                            sample_rate, byte_rate, block_align, bits))
        f.write(struct.pack("<4sI", _DATA, len(payload)))
        f.write(payload)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g,
                         axis=-1).astype(np.float32)


def load_mono_wave_numpy(path: str, target_sr: Optional[int] = None
                         ) -> Tuple[np.ndarray, int]:
    """Load wav -> mono (channel mean) -> optional resample; ([T] f32, sr).
    numpy and scipy's resample_poly: the plain version of the native
    decoder."""
    x, sr = read_wav(path)
    mono = x.mean(axis=0) if x.shape[0] > 1 else x[0]
    if target_sr is not None and sr != target_sr:
        mono = resample(mono, sr, target_sr)
        sr = target_sr
    return np.ascontiguousarray(mono, dtype=np.float32), sr


_count_lock = threading.Lock()


def _count(route: str) -> None:
    with _count_lock:  # decode threads call this concurrently
        setattr(load_mono_wave, route, getattr(load_mono_wave, route) + 1)


def load_mono_wave(path: str, target_sr: Optional[int] = None
                   ) -> Tuple[np.ndarray, int]:
    """Load wav -> mono (channel mean) -> optional resample; ([T] f32, sr),
    decoded natively. A file the native parser rejects, and every file when
    the native library could not be built, goes to `load_mono_wave_numpy`.
    `load_mono_wave.native_decodes` and `.numpy_decodes` count the route
    each call took."""
    from lct_gan_tpu_torch.ops.native.wav_loader import load_mono_wave_native

    out = load_mono_wave_native(path, target_sr or 0)
    if out is not None:
        _count("native_decodes")
        return out
    _count("numpy_decodes")
    return load_mono_wave_numpy(path, target_sr)


load_mono_wave.native_decodes = 0
load_mono_wave.numpy_decodes = 0


def read_scp(path: str) -> List[str]:
    """One utterance ID per line; blank lines and '#' comments skipped."""
    ids: List[str] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                ids.append(line)
    return ids

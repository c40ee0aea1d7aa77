"""STFT / iSTFT and time-frequency mask algebra.

Port of `lct_gan_tpu/sigproc/stft.py`, with torch.stft/torch.istft
semantics as the reference uses them:

  * center=True       -> reflect-pad n_fft//2 on both sides
  * onesided=True     -> rFFT, F = n_fft//2 + 1 bins
  * normalized=False  -> plain (unscaled) DFT
  * window='hann'     -> periodic Hann (torch.hann_window default)
  * istft             -> windowed overlap-add divided by the window-square
                         envelope, center-unpadded, optional `length` trim

Layouts match the JAX package: waveforms [B, T], spectra complex64
[B, F, N]. FFTs and the overlap-add are plain PyTorch (the JAX package runs
them in XLA, outside any Pallas kernel). The inverse OLA envelope depends
only on static shapes and is computed once on the host in float64.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "STFTConfig",
    "hann_window",
    "stft",
    "istft",
    "ComplexSTFT",
    "make_lct_stft",
    "magnitude",
    "compress",
    "decompress",
    "compute_compressed_irm",
    "decompress_mask",
    "apply_mask",
]


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """STFT/iSTFT configuration (the JAX package's STFTConfig)."""

    n_fft: int = 512
    hop_length: Optional[int] = None  # default: n_fft // 2
    win_length: Optional[int] = None  # default: n_fft
    window: str = "hann"
    center: bool = True
    pad_mode: str = "reflect"
    normalized: bool = False
    onesided: bool = True

    def finalize(self) -> "STFTConfig":
        """Fill hop_length/win_length defaults (frozen -> returns a copy)."""
        hop = self.hop_length if self.hop_length is not None else self.n_fft // 2
        win = self.win_length if self.win_length is not None else self.n_fft
        return dataclasses.replace(self, hop_length=hop, win_length=win)

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1 if self.onesided else self.n_fft

    def num_frames(self, num_samples: int) -> int:
        pad = self.n_fft // 2 if self.center else 0
        return 1 + (num_samples + 2 * pad - self.n_fft) // self.hop_length


@functools.lru_cache(maxsize=None)
def _hann_np(win_length: int) -> np.ndarray:
    """Periodic Hann window (same values as torch.hann_window(N))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def hann_window(win_length: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_hann_np(win_length).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _padded_window_np(cfg: STFTConfig) -> np.ndarray:
    """Window zero-padded symmetrically to n_fft, as torch.stft does."""
    if cfg.window != "hann":
        raise ValueError("Only 'hann' window is currently supported.")
    w = _hann_np(cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        left = (cfg.n_fft - cfg.win_length) // 2
        w = np.pad(w, (left, cfg.n_fft - cfg.win_length - left))
    elif cfg.win_length > cfg.n_fft:
        raise ValueError("win_length must be <= n_fft")
    return w


def _window(cfg: STFTConfig, device) -> torch.Tensor:
    return torch.from_numpy(_padded_window_np(cfg).copy()).to(device)


def stft(waveform: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Complex STFT of waveforms [B, T] -> complex64 [B, F, N]."""
    cfg = cfg.finalize()
    if waveform.ndim != 2:
        raise ValueError(f"Expected waveform [B, T], got {tuple(waveform.shape)}")
    x = waveform.to(torch.float32)
    if cfg.center:
        pad = cfg.n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode=cfg.pad_mode)[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)   # [B, N, n_fft]
    frames = frames * _window(cfg, x.device)
    if cfg.onesided:
        spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    else:
        spec = torch.fft.fft(frames, n=cfg.n_fft, dim=-1)
    if cfg.normalized:
        spec = spec / np.sqrt(cfg.n_fft)
    return spec.transpose(1, 2).to(torch.complex64)


@functools.lru_cache(maxsize=None)
def _ola_envelope_inv_np(cfg: STFTConfig, n_frames: int,
                         out_length: int) -> np.ndarray:
    """Reciprocal of the window-square overlap-add envelope."""
    w = _padded_window_np(cfg).astype(np.float64)
    w2 = w * w
    env = np.zeros(out_length, dtype=np.float64)
    for i in range(n_frames):
        s = i * cfg.hop_length
        env[s:s + cfg.n_fft] += w2
    # Zeros only ever occur inside the removed center padding.
    safe = np.where(env > 1e-11, env, 1.0)
    return (1.0 / safe).astype(np.float32)


def _overlap_add(frames: torch.Tensor, hop: int, out_length: int
                 ) -> torch.Tensor:
    """[B, N, L] frames -> [B, out_length] overlap-added signal."""
    B, N, L = frames.shape
    y = F.fold(frames.transpose(1, 2), output_size=(1, out_length),
               kernel_size=(1, L), stride=(1, hop))
    return y.reshape(B, out_length)


def istft(stft_matrix: torch.Tensor, cfg: STFTConfig,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT (torch.istft semantics): complex [B, F, N] -> [B, T]."""
    cfg = cfg.finalize()
    if stft_matrix.ndim != 3:
        raise ValueError(
            f"Expected stft_matrix [B, F, N], got {tuple(stft_matrix.shape)}")
    spec = stft_matrix.transpose(1, 2)            # [B, N, F]
    n_frames = spec.shape[1]
    if cfg.normalized:
        spec = spec * np.sqrt(cfg.n_fft)
    if cfg.onesided:
        frames = torch.fft.irfft(spec, n=cfg.n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, dim=-1).real
    frames = frames.to(torch.float32) * _window(cfg, spec.device)

    full_length = (n_frames - 1) * cfg.hop_length + cfg.n_fft
    y = _overlap_add(frames, cfg.hop_length, full_length)
    env_inv = torch.from_numpy(
        _ola_envelope_inv_np(cfg, n_frames, full_length).copy())
    y = y * env_inv.to(y.device)

    pad = cfg.n_fft // 2 if cfg.center else 0
    if length is None:
        return y[:, pad:full_length - pad]
    have = full_length - pad
    if length <= have:
        return y[:, pad:pad + length]
    return F.pad(y[:, pad:], (0, length - have))


class ComplexSTFT:
    """Stateless wrapper bundling a config (the JAX package's ComplexSTFT)."""

    def __init__(self, cfg: STFTConfig):
        if cfg.window.lower() != "hann":
            raise ValueError("Only 'hann' window is currently supported.")
        self.cfg = cfg.finalize()

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return stft(waveform, self.cfg)

    def istft(self, stft_matrix: torch.Tensor,
              length: Optional[int] = None) -> torch.Tensor:
        return istft(stft_matrix, self.cfg, length=length)


def make_lct_stft(n_fft: int = 512, hop_length: Optional[int] = None,
                  win_length: Optional[int] = None) -> ComplexSTFT:
    """The canonical 512-point / 50%-overlap / Hann STFT."""
    return ComplexSTFT(STFTConfig(
        n_fft=n_fft, hop_length=hop_length, win_length=win_length,
        window="hann", center=True, pad_mode="reflect", normalized=False,
        onesided=True))


# ====== Magnitude / compression helpers ======


def magnitude(stft_matrix: torch.Tensor, power: float = 1.0,
              eps: float = 1e-12) -> torch.Tensor:
    """Magnitude (or power) spectrogram, floored at eps."""
    mag = torch.clamp(stft_matrix.abs(), min=eps)
    if power != 1.0:
        mag = mag ** power
    return mag


def compress(x: torch.Tensor, c: float = 0.3, eps: float = 1e-12
             ) -> torch.Tensor:
    """Power-law magnitude compression x^c."""
    return torch.clamp(x, min=eps) ** c


def decompress(x_c: torch.Tensor, c: float = 0.3, eps: float = 1e-12
               ) -> torch.Tensor:
    """Undo magnitude compression x^(1/c)."""
    return torch.clamp(x_c, min=eps) ** (1.0 / c)


def compute_compressed_irm(clean_stft: torch.Tensor, noisy_stft: torch.Tensor,
                           c: float = 0.3, gamma: float = 1e-12,
                           eps: float = 1e-12) -> torch.Tensor:
    """Compressed ideal ratio mask |S|^c / (|X|^c + gamma)."""
    clean_mag_c = torch.clamp(clean_stft.abs(), min=eps) ** c
    noisy_mag_c = torch.clamp(noisy_stft.abs(), min=eps) ** c
    return clean_mag_c / (noisy_mag_c + gamma)


def decompress_mask(mask_c: torch.Tensor, c: float = 0.3,
                    eps: float = 1e-12) -> torch.Tensor:
    """Compressed mask -> linear domain."""
    return decompress(mask_c, c=c, eps=eps)


def apply_mask(noisy_stft: torch.Tensor, mask: torch.Tensor,
               compressed: bool = False, c: float = 0.3,
               eps: float = 1e-12) -> torch.Tensor:
    """Apply a (possibly compressed) real mask [B, F, N] or [B, 1, F, N] to a
    complex STFT [B, F, N]."""
    if mask.ndim == 4:
        if mask.shape[1] != 1:
            raise ValueError(
                f"Expected mask [B, 1, F, N], got {tuple(mask.shape)}")
        mask = mask[:, 0]
    if mask.ndim != 3:
        raise ValueError("Expected mask [B, F, N] (or [B, 1, F, N]), got "
                         f"{tuple(mask.shape)}")
    if compressed:
        mask = decompress_mask(mask, c=c, eps=eps)
    mask = torch.clamp(mask, min=0.0)
    return noisy_stft * mask.to(noisy_stft.dtype)

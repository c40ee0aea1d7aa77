"""Frequency-weighted segmental SNR (fwSegSNR) -- a fully self-contained
intrusive speech-quality metric, used as the documented stand-in for PESQ
when the external `pesq` C wheel is unavailable (see BASELINE.md,
"PESQ-unavailable acceptance procedure").

Follows Hu & Loizou (2008), "Evaluation of Objective Quality Measures for
Speech Enhancement", IEEE TASLP 16(1) -- the variant with per-band
spectral-magnitude weighting:

    fwSegSNR = (10/M) * sum_m  sum_j W(j,m) * SNR(j,m) / sum_j W(j,m)

where W(j,m) = |X(j,m)|^gamma (clean-speech band magnitude, gamma=0.2)
and SNR(j,m) = log10(|X(j,m)|^2 / (|X(j,m)| - |X_hat(j,m)|)^2), with the
per-frame weighted average clipped to [-10, 35] dB.

Parameterization used here (documented so numbers are reproducible):
30 ms Hann frames, 75% overlap, K=25 Mel-spaced triangular bands over
[0, sr/2]. Pure NumPy; no external packages.

Reference counterpart: none (the reference relies on the `pesq` wheel,
metrics.py:78-88); this module is new surface backing the acceptance
gate's fallback.

A copy of `lct_gan_tpu/metrics/fwsegsnr.py` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["fwsegsnr"]

_GAMMA = 0.2
_SNR_MIN, _SNR_MAX = -10.0, 35.0
_N_BANDS = 25


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _mel_filterbank(n_fft: int, sample_rate: int,
                    n_bands: int) -> np.ndarray:
    """[n_bands, n_fft//2+1] triangular Mel filters spanning [0, sr/2]."""
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0),
                          n_bands + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * sample_rate / n_fft
    fb = np.zeros((n_bands, n_bins), dtype=np.float64)
    for j in range(n_bands):
        lo, mid, hi = hz_pts[j], hz_pts[j + 1], hz_pts[j + 2]
        rising = (bin_freqs - lo) / max(mid - lo, 1e-12)
        falling = (hi - bin_freqs) / max(hi - mid, 1e-12)
        fb[j] = np.clip(np.minimum(rising, falling), 0.0, None)
    return fb


def _frames(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def fwsegsnr(clean: np.ndarray, enhanced: np.ndarray,
             sample_rate: int = 16000) -> float:
    """Frequency-weighted segmental SNR in dB (higher is better; bounded
    to [-10, 35] per frame). Identical signals score 35.0 exactly."""
    clean = np.asarray(clean, dtype=np.float64).reshape(-1)
    enhanced = np.asarray(enhanced, dtype=np.float64).reshape(-1)
    n = min(len(clean), len(enhanced))
    clean, enhanced = clean[:n], enhanced[:n]

    frame = int(0.030 * sample_rate)
    hop = frame // 4  # 75% overlap
    if n < frame:
        raise ValueError(
            f"signal too short for fwSegSNR: {n} samples < one "
            f"{frame}-sample frame")
    n_fft = 1 << (frame - 1).bit_length()

    win = np.hanning(frame)
    X = np.abs(np.fft.rfft(_frames(clean, frame, hop) * win, n_fft, axis=1))
    Y = np.abs(np.fft.rfft(_frames(enhanced, frame, hop) * win, n_fft,
                           axis=1))

    fb = _mel_filterbank(n_fft, sample_rate, _N_BANDS)
    Xb = X @ fb.T  # [M frames, K bands]
    Yb = Y @ fb.T

    eps = 1e-12
    w = np.power(np.maximum(Xb, eps), _GAMMA)
    snr = 10.0 * np.log10(
        np.square(Xb) / np.maximum(np.square(Xb - Yb), eps))
    per_frame = np.sum(w * snr, axis=1) / np.maximum(np.sum(w, axis=1), eps)
    per_frame = np.clip(per_frame, _SNR_MIN, _SNR_MAX)
    return float(np.mean(per_frame))

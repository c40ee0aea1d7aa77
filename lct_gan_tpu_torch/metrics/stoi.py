"""Short-Time Objective Intelligibility (STOI) and extended STOI (ESTOI),
implemented from the published algorithms:

  * C. H. Taal et al., "An Algorithm for Intelligibility Prediction of
    Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011 (STOI).
  * J. Jensen, C. H. Taal, "An Algorithm for Predicting the Intelligibility
    of Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016 (ESTOI).

The reference evaluates STOI through the external `pystoi` wheel
(metrics.py:91-102); where that package is absent, the framework
ships its own implementation with the same constants as the canonical
one (fs 10 kHz, 256-sample frames with 50% overlap, 512-pt FFT, 15
one-third-octave bands from 150 Hz, 30-frame segments, -15 dB SDR clip,
40 dB silent-frame dynamic range).

A copy of `lct_gan_tpu/metrics/stoi.py` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["stoi"]

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from lct_gan_tpu_torch.data.audio_io import resample

    return resample(x.astype(np.float32), fs, FS).astype(np.float64)


def _stft_frames(x: np.ndarray) -> np.ndarray:
    """Hann-windowed 50%-overlap frames -> [n_frames, NFFT//2+1] complex."""
    hop = N_FRAME // 2
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = np.stack([
        x[i * hop:i * hop + N_FRAME] * w for i in range(n_frames)
    ]) if n_frames else np.zeros((0, N_FRAME))
    return np.fft.rfft(frames, NFFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose clean-speech energy is more than DYN_RANGE dB
    below the loudest frame; reconstruct both signals by overlap-add."""
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    if n_frames == 0:
        return x, y
    xf = np.stack([x[i * hop:i * hop + N_FRAME] * w for i in range(n_frames)])
    yf = np.stack([y[i * hop:i * hop + N_FRAME] * w for i in range(n_frames)])
    energies = 20 * np.log10(np.linalg.norm(xf, axis=-1) + 1e-16)
    keep = energies > (energies.max() - DYN_RANGE)
    xf, yf = xf[keep], yf[keep]
    n_kept = xf.shape[0]
    out_len = (n_kept - 1) * hop + N_FRAME if n_kept else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n_kept):
        xs[i * hop:i * hop + N_FRAME] += xf[i]
        ys[i * hop:i * hop + N_FRAME] += yf[i]
    return xs, ys


def _third_octave_bands() -> np.ndarray:
    """[NUMBAND, NFFT//2+1] binary band matrix (one-third octaves from
    MINFREQ)."""
    f = np.linspace(0, FS, NFFT, endpoint=False)[:NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=np.float64)
    cf = MINFREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUMBAND, len(f)))
    for i in range(NUMBAND):
        lo_idx = np.argmin(np.square(f - lo[i]))
        hi_idx = np.argmin(np.square(f - hi[i]))
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI (or ESTOI when extended=True) of `denoised` against `clean`.

    Interface mirrors pystoi.stoi as used by the reference
    (metrics.py:91-102, train.py:351-364).
    """
    clean = np.asarray(clean, dtype=np.float64).reshape(-1)
    denoised = np.asarray(denoised, dtype=np.float64).reshape(-1)
    n = min(len(clean), len(denoised))
    if n == 0:
        raise ValueError("Empty signals")
    x = _resample(clean[:n], fs)
    y = _resample(denoised[:n], fs)

    x, y = _remove_silent_frames(x, y)

    X = _stft_frames(x)  # [M, F]
    Y = _stft_frames(y)
    if X.shape[0] < N_SEG:
        raise ValueError(
            "Signal too short (or fully silent) for STOI: "
            f"{X.shape[0]} frames < {N_SEG}")

    obm = _third_octave_bands()
    # TF units: sqrt of band-pooled power, [M, J] -> transposed [J, M]
    Xb = np.sqrt((obm @ (np.abs(X.T) ** 2)))  # [J, M]
    Yb = np.sqrt((obm @ (np.abs(Y.T) ** 2)))

    M = Xb.shape[1]
    if extended:
        # ESTOI: per-segment row+column normalized correlation.
        vals = []
        for m in range(N_SEG, M + 1):
            Xseg = Xb[:, m - N_SEG:m]
            Yseg = Yb[:, m - N_SEG:m]
            # Row (band) normalization
            Xn = Xseg - Xseg.mean(axis=1, keepdims=True)
            Xn /= (np.linalg.norm(Xn, axis=1, keepdims=True) + 1e-16)
            Yn = Yseg - Yseg.mean(axis=1, keepdims=True)
            Yn /= (np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-16)
            # Column (time-within-segment) normalization
            Xn = Xn - Xn.mean(axis=0, keepdims=True)
            Xn /= (np.linalg.norm(Xn, axis=0, keepdims=True) + 1e-16)
            Yn = Yn - Yn.mean(axis=0, keepdims=True)
            Yn /= (np.linalg.norm(Yn, axis=0, keepdims=True) + 1e-16)
            # Per-segment intermediate intelligibility: after row+column
            # normalization every column of Xn/Yn has unit norm, so the
            # normalizer is the SEGMENT LENGTH N (identical signals ->
            # N unit column dot-products / N = 1.0), not the band count
            # (which scored identity at N/J = 2.0).
            vals.append(np.sum(Xn * Yn) / N_SEG)
        return float(np.mean(vals))

    # STOI: clipped, normalized per-(band, segment) correlations.
    c = 10.0 ** (-BETA / 20.0)
    d_sum = 0.0
    count = 0
    for m in range(N_SEG, M + 1):
        Xseg = Xb[:, m - N_SEG:m]  # [J, N]
        Yseg = Yb[:, m - N_SEG:m]
        alpha = np.sqrt((Xseg ** 2).sum(axis=1, keepdims=True) /
                        ((Yseg ** 2).sum(axis=1, keepdims=True) + 1e-16))
        Yprime = np.minimum(alpha * Yseg, Xseg * (1 + c))
        xm = Xseg - Xseg.mean(axis=1, keepdims=True)
        ym = Yprime - Yprime.mean(axis=1, keepdims=True)
        corr = (xm * ym).sum(axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-16)
        d_sum += corr.sum()
        count += NUMBAND
    return float(d_sum / count)

"""Scale-invariant SDR (reference: metrics.py:10-54).

A copy of `lct_gan_tpu/metrics/sisdr.py` (numpy only).
"""

from __future__ import annotations



import numpy as np

__all__ = ["si_sdr", "batch_si_sdr"]


def si_sdr(reference: np.ndarray, estimate: np.ndarray,
           eps: float = 1e-8) -> float:
    """SI-SDR in dB between two 1D signals (trimmed to min length,
    zero-meaned, optimal scale projection)."""
    reference = np.asarray(reference, dtype=np.float64).reshape(-1)
    estimate = np.asarray(estimate, dtype=np.float64).reshape(-1)
    n = min(reference.shape[-1], estimate.shape[-1])
    reference = reference[:n] - reference[:n].mean()
    estimate = estimate[:n] - estimate[:n].mean()
    ref_energy = (reference ** 2).sum() + eps
    scale = (reference * estimate).sum() / ref_energy
    s_target = scale * reference
    e_noise = estimate - s_target
    return float(10.0 * np.log10(((s_target ** 2).sum() + eps) /
                                 ((e_noise ** 2).sum() + eps)))


def batch_si_sdr(reference: np.ndarray, estimate: np.ndarray,
                 lengths=None, eps: float = 1e-8) -> np.ndarray:
    """Vectorized SI-SDR over [B, T] batches with optional per-utterance
    lengths (reference: metrics.py:40-54)."""
    reference = np.asarray(reference, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    B, T = reference.shape
    if lengths is None:
        lengths = np.full((B,), min(T, estimate.shape[1]), dtype=np.int64)
    out = np.empty((B,), dtype=np.float64)
    for b in range(B):
        L = int(lengths[b])
        out[b] = si_sdr(reference[b, :L], estimate[b, :L], eps=eps)
    return out

"""Gated wrappers for external metric packages + the per-pair evaluator.

Certified PESQ (ITU-T P.862) requires the external `pesq` C wheel; like
the reference's lazy imports (metrics.py:57-75) it is gated, and the
certified `pesq_wb` slot reports NaN when the package is absent. In that
case the vendored estimator (metrics/pesq_p862.py -- the full
P.862 perceptual pipeline, openly approximate in its band tables) is
reported in a SEPARATE `pesq_wb_est` slot so estimates can never be
mistaken for certified scores; the BASELINE.md acceptance gate keys on
`pesq_available()` (wheel only). STOI always works: we prefer the
`pystoi` wheel when present (exact parity with the reference) and fall
back to our own implementation (metrics/stoi.py) otherwise.

A copy of `lct_gan_tpu/metrics/external.py` (numpy only).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from lct_gan_tpu_torch.metrics.sisdr import si_sdr

__all__ = ["pesq_score", "stoi_score", "compute_metrics_for_pair",
           "pesq_available"]

_PESQ = None
_PESQ_CHECKED = False
_PYSTOI = None
_PYSTOI_CHECKED = False


def _get_pesq():
    global _PESQ, _PESQ_CHECKED
    if not _PESQ_CHECKED:
        _PESQ_CHECKED = True
        try:
            from pesq import pesq as _p

            _PESQ = _p
        except ImportError:
            _PESQ = None
    return _PESQ


def _get_pystoi():
    global _PYSTOI, _PYSTOI_CHECKED
    if not _PYSTOI_CHECKED:
        _PYSTOI_CHECKED = True
        try:
            from pystoi import stoi as _s

            _PYSTOI = _s
        except ImportError:
            _PYSTOI = None
    return _PYSTOI


def pesq_available() -> bool:
    return _get_pesq() is not None


def pesq_score(clean: np.ndarray, enhanced: np.ndarray, sample_rate: int,
               mode: str = "wb") -> float:
    """Certified wideband PESQ (reference: metrics.py:78-88). NaN if the
    `pesq` package is unavailable (use `pesq_estimate` for the vendored
    approximation)."""
    f = _get_pesq()
    if f is None:
        return math.nan
    n = min(len(clean), len(enhanced))
    return float(f(sample_rate, np.asarray(clean[:n], dtype=np.float64),
                   np.asarray(enhanced[:n], dtype=np.float64), mode))


def pesq_estimate(clean: np.ndarray, enhanced: np.ndarray, sample_rate: int,
                  mode: str = "wb") -> float:
    """PESQ MOS-LQO: the certified wheel when importable, else the
    vendored P.862 estimator (metrics/pesq_p862.py)."""
    f = _get_pesq()
    if f is not None:
        return pesq_score(clean, enhanced, sample_rate, mode)
    from lct_gan_tpu_torch.metrics.pesq_p862 import pesq_p862

    return float(pesq_p862(clean, enhanced, sample_rate, mode))


def stoi_score(clean: np.ndarray, enhanced: np.ndarray, sample_rate: int,
               extended: bool = False) -> float:
    """STOI/ESTOI (reference: metrics.py:91-102); pystoi when installed,
    our native implementation otherwise."""
    n = min(len(clean), len(enhanced))
    f = _get_pystoi()
    if f is not None:
        return float(f(clean[:n], enhanced[:n], sample_rate,
                       extended=extended))
    from lct_gan_tpu_torch.metrics.stoi import stoi

    return stoi(clean[:n], enhanced[:n], sample_rate, extended=extended)


def compute_metrics_for_pair(clean_path: str, enhanced_path: str,
                             sample_rate: int = 16000,
                             include_pesq: bool = True,
                             include_stoi: bool = True,
                             include_fwsegsnr: bool = True,
                             include_si_sdr: bool = True,
                             estoi: bool = False
                             ) -> Dict[str, float]:
    """Load a clean/enhanced wav pair and compute SI-SDR / PESQ / STOI
    (reference: metrics.py:133-159; estoi/include_si_sdr mirror the
    reference CLI's --estoi/--no_si_sdr, metrics.py:190-207), plus
    fwSegSNR (our self-contained quality metric; the PESQ stand-in when
    the wheel is absent -- BASELINE.md acceptance procedure)."""
    from lct_gan_tpu_torch.data.audio_io import load_mono_wave

    clean, _ = load_mono_wave(clean_path, sample_rate)
    enhanced, _ = load_mono_wave(enhanced_path, sample_rate)
    out: Dict[str, float] = {}
    if include_si_sdr:
        out["si_sdr"] = si_sdr(clean, enhanced)
    if include_pesq:
        try:
            out["pesq_wb"] = pesq_score(clean, enhanced, sample_rate, "wb")
        except Exception:
            out["pesq_wb"] = math.nan
        if not pesq_available():
            # Vendored P.862 estimator in its own slot -- informational,
            # never a stand-in for the certified gate.
            try:
                out["pesq_wb_est"] = pesq_estimate(clean, enhanced,
                                                   sample_rate, "wb")
            except Exception:
                out["pesq_wb_est"] = math.nan
    if include_stoi:
        key = "estoi" if estoi else "stoi"
        try:
            out[key] = stoi_score(clean, enhanced, sample_rate,
                                  extended=estoi)
        except Exception:
            out[key] = math.nan
    if include_fwsegsnr:
        from lct_gan_tpu_torch.metrics.fwsegsnr import fwsegsnr

        try:
            out["fwsegsnr"] = fwsegsnr(clean, enhanced, sample_rate)
        except Exception:
            out["fwsegsnr"] = math.nan
    return out

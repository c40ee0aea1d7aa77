"""Time-frequency features and the compressed-IRM target for training
(`lct_gan_tpu/sigproc/features.py:28-78`).

A wave pair -> the noisy magnitude, its compressed form and the compressed
ideal ratio mask |S|^c / (|X|^c + gamma), from the port's STFT.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from lct_gan_tpu_torch.sigproc.stft import (STFTConfig, compress,
                                            compute_compressed_irm,
                                            magnitude, stft)

__all__ = ["TFFeaturesConfig", "compute_tf_features"]


@dataclasses.dataclass(frozen=True)
class TFFeaturesConfig:
    """The JAX package's TFFeaturesConfig."""

    n_fft: int = 512
    hop_length: Optional[int] = None
    win_length: Optional[int] = None
    c: float = 0.3
    compress_input: bool = False
    return_stfts: bool = True

    def stft_config(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                          win_length=self.win_length).finalize()


def compute_tf_features(noisy_wave: torch.Tensor, clean_wave: torch.Tensor,
                        cfg: TFFeaturesConfig = TFFeaturesConfig()
                        ) -> Dict[str, torch.Tensor]:
    """[B, T] wave pair -> {noisy_mag, irm_c, noisy_mag_c[, noisy_stft,
    clean_stft]}, spectra [B, F, N]."""
    if noisy_wave.ndim != 2 or clean_wave.ndim != 2:
        raise ValueError(f"Expected [B, T] waves, got {tuple(noisy_wave.shape)}"
                         f", {tuple(clean_wave.shape)}")
    if noisy_wave.shape != clean_wave.shape:
        raise ValueError("noisy_wave and clean_wave must have same shape, got "
                         f"{tuple(noisy_wave.shape)} vs "
                         f"{tuple(clean_wave.shape)}")
    scfg = cfg.stft_config()
    noisy_stft = stft(noisy_wave, scfg)
    clean_stft = stft(clean_wave, scfg)
    noisy_mag = magnitude(noisy_stft)
    irm_c = compute_compressed_irm(clean_stft, noisy_stft, c=cfg.c)
    noisy_mag_c = compress(noisy_mag, c=cfg.c)
    feats = {"noisy_mag": noisy_mag_c if cfg.compress_input else noisy_mag,
             "irm_c": irm_c, "noisy_mag_c": noisy_mag_c}
    if cfg.return_stfts:
        feats["noisy_stft"] = noisy_stft
        feats["clean_stft"] = clean_stft
    return feats

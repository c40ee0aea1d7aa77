"""Training losses (`lct_gan_tpu/losses/losses.py:31-221`): multi-resolution
STFT, LS / hinge GAN, feature matching, compressed-mask MSE.

Every discriminator-logit and feature-map loss is a mean over a whole
tensor, so it does not depend on the layout (the port's discriminators run
NCHW, the JAX package's channels-last).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from lct_gan_tpu_torch.sigproc.stft import STFTConfig, magnitude, stft

__all__ = ["MRSTFTLossConfig", "mr_stft_loss", "mr_stft_loss_per_sample",
           "discriminator_loss", "generator_adv_loss",
           "feature_matching_loss", "mask_mse_loss", "flatten_logits_lists"]


@dataclasses.dataclass(frozen=True)
class MRSTFTLossConfig:
    """320/512/768-point resolutions, hop 0.5; the 512 resolution weighs 2."""

    fft_sizes: Tuple[int, ...] = (320, 512, 768)
    hop_factors: Tuple[float, ...] = (0.5, 0.5, 0.5)
    mag_weight: float = 1.0
    complex_weight: float = 1.0
    main_fft_size: int = 512
    main_fft_weight: float = 2.0
    default_weight: float = 1.0

    def stft_configs(self) -> Tuple[STFTConfig, ...]:
        return tuple(
            STFTConfig(n_fft=n, hop_length=int(round(n * h)),
                       win_length=n).finalize()
            for n, h in zip(self.fft_sizes, self.hop_factors))

    def weights(self) -> Tuple[float, ...]:
        return tuple(self.main_fft_weight if n == self.main_fft_size
                     else self.default_weight for n in self.fft_sizes)


def _check_waves(name, y_hat, y):
    if y_hat.ndim != 2 or y.ndim != 2:
        raise ValueError(f"{name} wants 2-D [batch, samples] waveforms; got "
                         f"{tuple(y_hat.shape)} and {tuple(y.shape)}")


def _resolution_terms(y_hat, y, cfg, dims):
    """Per resolution: (weight, magnitude MSE, complex MSE), means over
    `dims` of the [B, F, N] spectra."""
    for scfg, w in zip(cfg.stft_configs(), cfg.weights()):
        Y_hat, Y = stft(y_hat, scfg), stft(y, scfg)
        mag = (magnitude(Y_hat) - magnitude(Y)).square().mean(dim=dims)
        diff = Y_hat - Y
        cplx = (diff.real.square() + diff.imag.square()).mean(dim=dims)
        yield w, mag, cplx


def mr_stft_loss(y_hat: torch.Tensor, y: torch.Tensor,
                 cfg: MRSTFTLossConfig = MRSTFTLossConfig()
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-resolution STFT loss: per resolution, magnitude MSE + mean
    squared complex difference, weighted and normalised by the weight sum.
    Returns (total, {mrstft_total, mrstft_mag, mrstft_complex} detached)."""
    _check_waves("mr_stft_loss", y_hat, y)
    total = mag_total = complex_total = 0.0
    weight_sum = 0.0
    for w, mag, cplx in _resolution_terms(y_hat, y, cfg, None):
        total = total + w * (cfg.mag_weight * mag + cfg.complex_weight * cplx)
        mag_total = mag_total + w * mag
        complex_total = complex_total + w * cplx
        weight_sum += w
    if weight_sum > 0:
        total = total / weight_sum
        mag_total = mag_total / weight_sum
        complex_total = complex_total / weight_sum
    details = {"mrstft_total": total.detach(),
               "mrstft_mag": mag_total.detach(),
               "mrstft_complex": complex_total.detach()}
    return total, details


def mr_stft_loss_per_sample(y_hat: torch.Tensor, y: torch.Tensor,
                            cfg: MRSTFTLossConfig = MRSTFTLossConfig()
                            ) -> torch.Tensor:
    """`mr_stft_loss` per utterance: means over frequency and time only,
    [B]. Validation uses it to leave padded rows out of its mean."""
    _check_waves("mr_stft_loss_per_sample", y_hat, y)
    total = torch.zeros((y.shape[0],), dtype=torch.float32, device=y.device)
    weight_sum = 0.0
    for w, mag, cplx in _resolution_terms(y_hat, y, cfg, (1, 2)):
        total = total + w * (cfg.mag_weight * mag + cfg.complex_weight * cplx)
        weight_sum += w
    if weight_sum > 0:
        total = total / weight_sum
    return total


def flatten_logits_lists(*logits_lists) -> List[torch.Tensor]:
    """Concatenate the MPD and MSD logits lists."""
    flat: List[torch.Tensor] = []
    for lst in logits_lists:
        flat.extend(list(lst))
    return flat


def discriminator_loss(real_logits: Sequence[torch.Tensor],
                       fake_logits: Sequence[torch.Tensor],
                       loss_type: str = "ls") -> torch.Tensor:
    """LS or hinge discriminator loss, averaged over logit tensors."""
    if len(real_logits) != len(fake_logits):
        raise ValueError(f"logit list mismatch: {len(real_logits)} real vs "
                         f"{len(fake_logits)} fake")
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        if loss_type == "ls":
            loss = loss + (r - 1.0).square().mean() + f.square().mean()
        elif loss_type == "hinge":
            loss = (loss + torch.relu(1.0 - r).mean()
                    + torch.relu(1.0 + f).mean())
        else:
            raise ValueError(f"Unknown loss_type: {loss_type}")
    return loss / max(len(real_logits), 1)


def generator_adv_loss(fake_logits: Sequence[torch.Tensor],
                       loss_type: str = "ls") -> torch.Tensor:
    """LS ((f - 1)^2) or hinge (-f) generator loss, averaged over tensors."""
    loss = 0.0
    for f in fake_logits:
        if loss_type == "ls":
            loss = loss + (f - 1.0).square().mean()
        elif loss_type == "hinge":
            loss = loss - f.mean()
        else:
            raise ValueError(f"Unknown loss_type: {loss_type}")
    return loss / max(len(fake_logits), 1)


def feature_matching_loss(real_fmaps: Sequence[Sequence[torch.Tensor]],
                          fake_fmaps: Sequence[Sequence[torch.Tensor]]
                          ) -> torch.Tensor:
    """L1 over every (real, fake) feature-map pair, averaged by pair count.
    The mean accumulates in f32 even for bf16 feature maps."""
    if len(real_fmaps) != len(fake_fmaps):
        raise ValueError(f"fmap outer-list mismatch: {len(real_fmaps)} real "
                         f"vs {len(fake_fmaps)} fake sub-discriminators")
    loss = 0.0
    count = 0
    for r_list, f_list in zip(real_fmaps, fake_fmaps):
        if len(r_list) != len(f_list):
            raise ValueError(f"one sub-discriminator produced {len(r_list)} "
                             f"real but {len(f_list)} fake feature maps")
        for r, f in zip(r_list, f_list):
            loss = loss + (f - r).abs().mean(dtype=torch.float32)
            count += 1
    if count == 0:
        return torch.tensor(0.0)
    return loss / count


def mask_mse_loss(pred_mask_c: torch.Tensor,
                  target_mask_c: torch.Tensor) -> torch.Tensor:
    """MSE between the predicted compressed mask and IRM^c."""
    if pred_mask_c.shape != target_mask_c.shape:
        raise ValueError(f"Shape mismatch: pred {tuple(pred_mask_c.shape)} vs "
                         f"target {tuple(target_mask_c.shape)}")
    return (pred_mask_c - target_mask_c).square().mean()

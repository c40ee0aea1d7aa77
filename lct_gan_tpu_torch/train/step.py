"""The GAN optimisation step (D step, then G step) and the eval step
(`lct_gan_tpu/train/step.py:50-289`).

Per batch, as the reference schedules it:
  1. the compressed-IRM target from the TF features;
  2. ONE enhancer forward with grad; the D step sees it detached;
  3. D update (AdamW);
  4. G step against the UPDATED discriminators: MR-STFT + lambda_mask *
     mask MSE + lambda_adv * (adv + lambda_fm * FM), back-propagated through
     the same forward;
  5. G update with the global-norm clip.

Real and fake go through each discriminator stack as one concatenated batch
on the weight-norm path and under fast_spectral_norm; parity spectral norm
keeps the reference's sequential clean / fake order, since every training
forward advances u/v. Gradients are taken with `torch.autograd.grad` for
exactly the parameters being updated, so the G step leaves nothing in D.

On the card the step is deterministic: the FTF kernels have no atomics,
the STFT's reflect pad has an atomic-free backward, and cuDNN is asked for
deterministic algorithms.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from lct_gan_tpu_torch.losses import (discriminator_loss,
                                      feature_matching_loss,
                                      flatten_logits_lists,
                                      generator_adv_loss, mask_mse_loss,
                                      mr_stft_loss, mr_stft_loss_per_sample)
from lct_gan_tpu_torch.sigproc.features import (TFFeaturesConfig,
                                                compute_tf_features)
from lct_gan_tpu_torch.train.state import (GanTrainState, TrainConfig,
                                           clip_by_global_norm)

__all__ = ["make_train_step", "make_eval_step", "align_tf_targets",
           "discriminator_step_loss", "generator_step_loss", "masked_si_sdr"]


def align_tf_targets(irm_c: torch.Tensor, pred_mask_c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop the IRM target and the predicted mask to the shorter frame
    count."""
    t = min(irm_c.shape[-1], pred_mask_c.shape[-1])
    return irm_c[..., :t], pred_mask_c[..., :t]


def _apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def discriminator_step_loss(cfg: TrainConfig, mpd, msd, clean: torch.Tensor,
                            fake: torch.Tensor) -> torch.Tensor:
    """The D loss on real `clean` and (detached) `fake` rows. Concat-
    batched through each stack on the weight-norm path and under
    fast_spectral_norm; parity spectral norm runs clean, then fake, through
    each stack (each forward one power iteration)."""
    use_sn = cfg.use_spectral_norm
    b = clean.shape[0]
    if (not use_sn) or cfg.fast_spectral_norm:
        both = torch.cat([clean, fake])
        mpd_l, _ = mpd(both, use_sn)
        msd_l, _ = msd(both, use_sn)
        real_l = flatten_logits_lists([l[:b] for l in mpd_l],
                                      [l[:b] for l in msd_l])
        fake_l = flatten_logits_lists([l[b:] for l in mpd_l],
                                      [l[b:] for l in msd_l])
    else:
        mpd_real, _ = mpd(clean, True)
        mpd_fake, _ = mpd(fake, True)
        msd_real, _ = msd(clean, True)
        msd_fake, _ = msd(fake, True)
        real_l = flatten_logits_lists(mpd_real, msd_real)
        fake_l = flatten_logits_lists(mpd_fake, msd_fake)
    return discriminator_loss(real_l, fake_l, loss_type=cfg.gan_loss)


def generator_step_loss(cfg: TrainConfig, mpd, msd, enhanced: torch.Tensor,
                        mask_c: torch.Tensor, irm_c: torch.Tensor,
                        clean: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The G loss MR-STFT + lambda_mask * mask MSE + lambda_adv * (adv +
    lambda_fm * FM) and its terms. The real rows' feature maps are
    constants (no gradient reaches G through them)."""
    use_sn = cfg.use_spectral_norm
    b = enhanced.shape[0]
    mr_loss, _ = mr_stft_loss(enhanced, clean)
    irm_a, pred_a = align_tf_targets(irm_c, mask_c[:, 0])
    m_loss = mask_mse_loss(pred_a, irm_a)
    if (not use_sn) or cfg.fast_spectral_norm:
        both = torch.cat([enhanced, clean])
        mpd_l, mpd_fm = mpd(both, use_sn)
        msd_l, msd_fm = msd(both, use_sn)
        adv_logits = flatten_logits_lists([l[:b] for l in mpd_l],
                                          [l[:b] for l in msd_l])
        fake_fm = [[f[:b] for f in fs] for fs in mpd_fm + msd_fm]
        real_fm = [[f[b:].detach() for f in fs] for fs in mpd_fm + msd_fm]
    else:
        mpd_fake, mpd_fake_fm = mpd(enhanced, True)
        msd_fake, msd_fake_fm = msd(enhanced, True)
        with torch.no_grad():
            _, mpd_real_fm = mpd(clean, True)
            _, msd_real_fm = msd(clean, True)
        adv_logits = flatten_logits_lists(mpd_fake, msd_fake)
        fake_fm = mpd_fake_fm + msd_fake_fm
        real_fm = mpd_real_fm + msd_real_fm
    adv_loss = generator_adv_loss(adv_logits, loss_type=cfg.gan_loss)
    fm_loss = feature_matching_loss(real_fm, fake_fm)
    g_loss = (mr_loss + cfg.lambda_mask * m_loss
              + cfg.lambda_adv * (adv_loss + cfg.lambda_fm * fm_loss))
    return g_loss, {"mr_loss": mr_loss, "mask_loss": m_loss,
                    "adv_loss": adv_loss, "fm_loss": fm_loss}


def make_train_step(cfg: TrainConfig) -> Callable:
    """`step(state, noisy, clean, mark=None) -> metrics`: one D and one G
    update of `state` in place; metrics {d_loss, g_loss, mr_loss,
    mask_loss, adv_loss, fm_loss} as detached 0-d tensors. noisy, clean:
    [B, T] arrays or tensors. `mark(phase)`, when given, is called after
    "forward", "d_step" and "g_step" (a timer hook)."""
    tf_cfg = TFFeaturesConfig(n_fft=512, c=cfg.compress_c,
                              compress_input=False, return_stfts=False)

    def step(state: GanTrainState, noisy, clean,
             mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda phase: None)
        enhancer, mpd, msd = state.enhancer, state.mpd, state.msd
        dev = next(enhancer.parameters()).device
        if dev.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        noisy = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
        clean = torch.as_tensor(clean, dtype=torch.float32, device=dev)
        with torch.no_grad():
            irm_c = compute_tf_features(noisy, clean, tf_cfg)["irm_c"]
        enhanced, mask_c = enhancer(noisy)
        mark("forward")

        d_loss = discriminator_step_loss(cfg, mpd, msd, clean,
                                         enhanced.detach())
        d_params = state.d_params()
        _apply_grads(state.d_opt, d_params,
                     torch.autograd.grad(d_loss, d_params))
        mark("d_step")

        g_loss, aux = generator_step_loss(cfg, mpd, msd, enhanced, mask_c,
                                          irm_c, clean)
        g_params = state.g_params()
        g_grads = list(torch.autograd.grad(g_loss, g_params))
        if cfg.grad_clip > 0:
            g_grads = clip_by_global_norm(g_grads, cfg.grad_clip)
        _apply_grads(state.g_opt, g_params, g_grads)
        state.step += 1
        mark("g_step")
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    return step


def make_eval_step(cfg: TrainConfig) -> Callable:
    """`eval_step(enhancer, noisy, clean, lengths) -> (enhanced [B, T],
    {mrstft [B], si_sdr [B]})` under inference mode; `lengths` masks the
    time attention's keys and the SI-SDR, and per-sample MR-STFT lets the
    caller leave padded rows out of its mean."""

    def eval_step(enhancer, noisy, clean, lengths):
        dev = next(enhancer.parameters()).device
        with torch.inference_mode():
            noisy = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
            clean = torch.as_tensor(clean, dtype=torch.float32, device=dev)
            lengths = torch.as_tensor(lengths, dtype=torch.long, device=dev)
            enhanced, _ = enhancer(noisy, lengths)
            mr = mr_stft_loss_per_sample(enhanced, clean)
            si = masked_si_sdr(clean, enhanced, lengths)
        return enhanced, {"mrstft": mr, "si_sdr": si}

    return eval_step


def masked_si_sdr(reference: torch.Tensor, estimate: torch.Tensor,
                  lengths: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance SI-SDR over zero-padded rows [B, T] -> [B]."""
    B, T = reference.shape
    mask = (torch.arange(T, device=reference.device)[None, :]
            < lengths[:, None]).to(torch.float32)
    n = torch.clamp(lengths.to(torch.float32), min=1.0)
    ref = (reference - (reference * mask).sum(-1, keepdim=True)
           / n[:, None]) * mask
    est = (estimate - (estimate * mask).sum(-1, keepdim=True)
           / n[:, None]) * mask
    ref_energy = (ref * ref).sum(-1) + eps
    scale = (ref * est).sum(-1) / ref_energy
    s_target = scale[:, None] * ref
    e_noise = est - s_target
    return 10.0 * torch.log10(((s_target * s_target).sum(-1) + eps)
                              / ((e_noise * e_noise).sum(-1) + eps))

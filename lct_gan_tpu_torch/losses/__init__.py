from lct_gan_tpu_torch.losses.losses import (MRSTFTLossConfig,
                                             discriminator_loss,
                                             feature_matching_loss,
                                             flatten_logits_lists,
                                             generator_adv_loss, mask_mse_loss,
                                             mr_stft_loss,
                                             mr_stft_loss_per_sample)

__all__ = ["MRSTFTLossConfig", "discriminator_loss", "feature_matching_loss",
           "flatten_logits_lists", "generator_adv_loss", "mask_mse_loss",
           "mr_stft_loss", "mr_stft_loss_per_sample"]

"""The GAN train step of the port: losses, discriminators, train state."""

from lct_gan_tpu_torch.train.state import (GanTrainState, TrainConfig,
                                           build_models, clip_by_global_norm,
                                           create_state, make_optimizers,
                                           state_from_jax_params)
from lct_gan_tpu_torch.train.step import (align_tf_targets,
                                          discriminator_step_loss,
                                          generator_step_loss, make_eval_step,
                                          make_train_step, masked_si_sdr)

__all__ = ["GanTrainState", "TrainConfig", "align_tf_targets", "build_models",
           "clip_by_global_norm", "create_state", "discriminator_step_loss",
           "generator_step_loss", "make_eval_step",
           "make_optimizers", "make_train_step", "masked_si_sdr",
           "state_from_jax_params"]

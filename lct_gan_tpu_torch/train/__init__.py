"""The GAN training of the port: losses, discriminators, train state and
step, checkpoints and the epoch loop."""

from lct_gan_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                read_checkpoint_meta,
                                                restore_checkpoint,
                                                save_checkpoint)
from lct_gan_tpu_torch.train.loop import DataConfig, run_training, validate
from lct_gan_tpu_torch.train.state import (GanTrainState, TrainConfig,
                                           build_models, clip_by_global_norm,
                                           create_state, make_optimizers,
                                           state_from_jax_params)
from lct_gan_tpu_torch.train.step import (align_tf_targets,
                                          discriminator_step_loss,
                                          generator_step_loss, make_eval_step,
                                          make_train_step, masked_si_sdr)

__all__ = ["DataConfig", "GanTrainState", "TrainConfig", "align_tf_targets",
           "build_models", "clip_by_global_norm", "create_state",
           "discriminator_step_loss", "generator_step_loss",
           "latest_checkpoint", "make_eval_step", "make_optimizers",
           "make_train_step", "masked_si_sdr", "read_checkpoint_meta",
           "restore_checkpoint", "run_training", "save_checkpoint",
           "state_from_jax_params", "validate"]

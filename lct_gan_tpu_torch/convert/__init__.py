from lct_gan_tpu_torch.convert.weights import (jax_disc_params_to_state_dict,
                                               jax_params_to_state_dict,
                                               load_enhancer, read_npz_params,
                                               save_generator_params_npz,
                                               state_dict_to_jax_params)

__all__ = ["jax_disc_params_to_state_dict", "jax_params_to_state_dict",
           "load_enhancer", "read_npz_params", "save_generator_params_npz",
           "state_dict_to_jax_params"]

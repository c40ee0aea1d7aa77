from lct_gan_tpu_torch.convert.weights import (jax_params_to_state_dict,
                                               load_enhancer, read_npz_params)

__all__ = ["jax_params_to_state_dict", "load_enhancer", "read_npz_params"]

from lct_gan_tpu_torch.utils.device import (disable_tf32,
                                            gpu_name_and_power_limit,
                                            resolve_device)

__all__ = ["disable_tf32", "gpu_name_and_power_limit", "resolve_device"]

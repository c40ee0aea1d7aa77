from lct_gan_tpu_torch.eval.serve import make_enhance
from lct_gan_tpu_torch.eval.streaming import (StreamingEnhancer,
                                              enhance_in_chunks)

__all__ = ["make_enhance", "StreamingEnhancer", "enhance_in_chunks"]

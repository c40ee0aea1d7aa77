from lct_gan_tpu_torch.eval.serve import make_enhance

__all__ = ["make_enhance"]

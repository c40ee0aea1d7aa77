"""Kernels of the port: each wrapper launches its hand-written CUDA kernel on
a CUDA tensor and computes its plain PyTorch version on a CPU tensor."""

from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, fused_ftf_block

__all__ = ["fused_mhsa", "mhsa_reference", "banded_mhsa",
           "banded_mhsa_reference", "ftf_block_reference", "fused_ftf_block"]

"""Kernels of the port: each is a `torch.library` custom op in the namespace
`lct_gan_tpu_torch` (`torch.ops.lct_gan_tpu_torch.fused_ftf_block`,
`fused_ftf_bwd`, `fused_mhsa`, `banded_mhsa`) whose CUDA kernel launches the
hand-written CUDA kernel and whose CPU kernel is its plain PyTorch version;
importing this package registers them."""

from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, fused_ftf_block
from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_reference, fused_ftf_bwd

__all__ = ["fused_mhsa", "mhsa_reference", "banded_mhsa",
           "banded_mhsa_reference", "ftf_block_reference", "fused_ftf_block",
           "ftf_bwd_reference", "fused_ftf_bwd"]

"""Serving with fixed weights (`lct_gan_tpu/eval/serve.py:30
bake_enhance`).

The JAX package bakes the weights into a jitted program; here the
enhancer's weights are simply held fixed and every call runs under
`torch.inference_mode()` (no autograd records). No CUDA graph is
captured: each FTF block is a few kernel launches at any length (the fused
block up to L = 512; above it the composed block, whose LN1 and GRU
recurrence are one operator, `ops/gru.py::fused_grouped_gru`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lct_gan_tpu_torch.models.generator import LctEnhancer, check_card_widths

__all__ = ["make_enhance"]


def make_enhance(enhancer: LctEnhancer
                 ) -> Callable[..., torch.Tensor]:
    """Return `enhance(noisy, lengths=None) -> enhanced [B, T]` on the
    enhancer's device. `noisy` and `lengths` may be numpy arrays or tensors;
    the result stays on the device. On the card the enhancer's widths must
    be the kernels' (`check_card_widths`: num_heads and gru_groups
    dividing enc_channels[-1], their padded layout within 512 channels);
    it raises here otherwise."""
    enhancer.eval()
    device = next(enhancer.parameters()).device
    check_card_widths(enhancer.gen.cfg, device, training=False)

    def enhance(noisy, lengths: Optional[object] = None) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(noisy, dtype=torch.float32, device=device)
            ln = None
            if lengths is not None:
                ln = torch.as_tensor(lengths, dtype=torch.long, device=device)
            out, _ = enhancer(x, ln)
            return out

    return enhance

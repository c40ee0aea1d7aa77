"""Multi-head self-attention with torch.nn.MultiheadAttention's parameters
(`lct_gan_tpu/models/attention.py:125-229`).

Parameter names are torch's (`in_proj_weight` [3E, E], `in_proj_bias`,
`out_proj.weight`, `out_proj.bias`) so reference state_dicts load strictly.

Dispatch, as in the JAX package (`lct_gan_tpu/models/attention.py:180-194`);
each kernel wrapper runs its CUDA kernel on the card and its plain version on
the CPU:
  * a band (`lookback`) at S >= 769: the banded kernel wrapper
    (ops/banded_attention.py), O(S * W), any S;
  * otherwise S <= 1024: the fused MHSA kernel wrapper (ops/attention.py),
    with or without a band;
  * S > 1024, unbanded: the plain f32 path (the JAX package's jnp path).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lct_gan_tpu_torch.ops.attention import (MAX_PALLAS_SEQ, fused_mhsa,
                                             mhsa_reference)
from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa

__all__ = ["MultiHeadSelfAttention", "BANDED_KERNEL_MIN_SEQ"]

# Banded calls at or above this length take the banded kernel, as in the
# JAX package (models/attention.py:115), so routing and launch counts mirror
# it; the card's own crossover against the MHSA kernel is measured by
# chip_smoke.py, not acted on.
BANDED_KERNEL_MIN_SEQ = 769


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int = 64, num_heads: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def kernel_params(self):
        """(in_w [E, 3E], in_b, out_w [E, E], out_b) in the kernels' layout."""
        return (self.in_proj_weight.t(), self.in_proj_bias,
                self.out_proj.weight.t(), self.out_proj.bias)

    def forward(self, x: torch.Tensor, lookback: Optional[int] = None,
                key_bias: Optional[torch.Tensor] = None, *,
                precise: bool = False) -> torch.Tensor:
        """x [B, S, E]; lookback: inclusive causal band; key_bias: [B, S]
        additive per-key bias (0 / -1e30); precise: all-f32 kernel GEMMs."""
        B, S, E = x.shape
        if E != self.embed_dim:
            raise ValueError(f"Expected embed dim {self.embed_dim}, got {E}")
        params = self.kernel_params()
        if lookback is not None and S >= BANDED_KERNEL_MIN_SEQ:
            return banded_mhsa(x, *params, num_heads=self.num_heads,
                               lookback=lookback, key_bias=key_bias,
                               precise=precise)
        if S <= MAX_PALLAS_SEQ:
            return fused_mhsa(x, *params, num_heads=self.num_heads,
                              lookback=lookback, key_bias=key_bias,
                              precise=precise)
        return mhsa_reference(x, *params, num_heads=self.num_heads,
                              lookback=lookback, key_bias=key_bias)

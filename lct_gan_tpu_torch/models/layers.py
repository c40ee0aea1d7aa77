"""LayerNorm with the JAX package's math (`lct_gan_tpu/models/layers.py`).

flax's fast-variance form, max(0, E[x^2] - mu^2), with eps 1e-6 (torch's
nn.LayerNorm uses the two-pass variance and eps 1e-5). Parameter names are
torch's (`weight`, `bias`), so reference state_dicts load as they are.
The JAX package's `Dense` is `nn.Linear` here: same math, reference names.
"""

from __future__ import annotations

import torch
from torch import nn

from lct_gan_tpu_torch.ops.gru import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)

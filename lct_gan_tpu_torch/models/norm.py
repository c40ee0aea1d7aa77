"""Weight-normalised and spectral-normalised convolutions of the waveform
discriminators (`lct_gan_tpu/models/norm.py:26-150`).

Both are written out as `F.conv1d` / `F.conv2d` over explicit parameters,
so the state_dict keys are the reference's (torch.nn.utils.weight_norm's
`weight_g` / `weight_v`, spectral_norm's `weight_orig` / `weight_u` /
`weight_v`) and the arithmetic is the JAX package's:

  * WNConv:  w = g * v / max(||v||, 1e-12), the norm over every axis but
    the output axis (torch's weight_norm has no clamp; the JAX package's
    does);
  * SNConv:  w = weight / sigma, sigma = u . (W v) on the [out, -1]
    matricisation W. With `update=True` (a training forward) one power
    iteration on the detached W first replaces the buffers u and v, and
    sigma uses the updated vectors; the division is unguarded, as torch's.

`dtype` is the compute type: bf16 casts the input and the normalised
weight, and the output stays bf16 (the bias is added inside the conv, in its
f32 accumulator). Parameters stay f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["WNConv", "SNConv"]


def _conv(x, w, b, stride, padding, groups, dtype):
    fn = F.conv1d if w.ndim == 3 else F.conv2d
    return fn(x.to(dtype), w.to(dtype), b.to(dtype), stride=tuple(stride),
              padding=tuple(padding), groups=groups)


def _fan_in_uniform(shape, generator):
    """flax variance_scaling(1/3, "fan_in", "uniform"): U(-b, b) with
    b = sqrt(1 / fan_in), fan_in = in/groups * prod(kernel)."""
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    bound = (1.0 / fan_in) ** 0.5
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class _NormConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int],
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.groups, self.dtype = groups, dtype
        self.shape = (out_ch, in_ch // groups, *kernel_size)


class WNConv(_NormConv):
    """Conv1d / Conv2d (by the rank of kernel_size) with weight norm."""

    def __init__(self, *args, generator=None, **kwargs):
        super().__init__(*args, **kwargs)
        v = _fan_in_uniform(self.shape, generator)
        self.weight_v = nn.Parameter(v)
        # torch's weight_norm starts from g = ||v||, so w == v at init.
        self.weight_g = nn.Parameter(self._norm(v))
        self.bias = nn.Parameter(torch.zeros(self.shape[0]))

    @staticmethod
    def _norm(v):
        return v.square().sum(dim=tuple(range(1, v.ndim)),
                              keepdim=True).sqrt()

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g / self._norm(v).clamp_min(1e-12))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        """`update` is SNConv's flag; weight norm has no buffers to update."""
        return _conv(x, self.weight(), self.bias, self.stride, self.padding,
                     self.groups, self.dtype)


def _l2normalize(t: torch.Tensor) -> torch.Tensor:
    return t / t.norm().clamp_min(1e-12)


class SNConv(_NormConv):
    """Conv1d / Conv2d with spectral norm; u and v are buffers."""

    def __init__(self, *args, generator=None, **kwargs):
        super().__init__(*args, **kwargs)
        out_ch = self.shape[0]
        n_cols = 1
        for s in self.shape[1:]:
            n_cols *= s
        self.weight_orig = nn.Parameter(
            _fan_in_uniform(self.shape, generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("weight_u", _l2normalize(
            torch.randn(out_ch, generator=generator)))
        self.register_buffer("weight_v", _l2normalize(
            torch.randn(n_cols, generator=generator)))

    def weight(self, update: bool = False) -> torch.Tensor:
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        if update:
            with torch.no_grad():
                v = _l2normalize(mat.t() @ self.weight_u)
                u = _l2normalize(mat @ v)
                self.weight_v.copy_(v)
                self.weight_u.copy_(u)
        # Copies: a later forward updates the buffers in place, and this
        # forward's graph must keep the vectors its sigma used.
        sigma = self.weight_u.clone() @ (mat @ self.weight_v.clone())
        return w / sigma

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        return _conv(x, self.weight(update), self.bias, self.stride,
                     self.padding, self.groups, self.dtype)

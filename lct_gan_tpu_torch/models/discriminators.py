"""Multi-period (MPD) and multi-scale (MSD) waveform discriminators
(`lct_gan_tpu/models/discriminators.py:34-200`), HiFi-GAN style.

The port runs NCHW / NCT, the JAX package channels-last; every loss over
the logits and feature maps is a mean, so only a test comparing feature
maps sees the layout. Module names are the reference's
(`discriminators.{i}.convs.{j}`, `discriminators.{i}.conv_post`), so
exported state_dicts load with strict=True.

`forward(x, update_sn=False)`: with update_sn, every spectral-norm conv
runs one power iteration (a training forward); logits are [B, 1, H, W] (MPD)
or [B, 1, T'] (MSD), cast to f32; feature maps stay in the compute dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lct_gan_tpu_torch.models.norm import SNConv, WNConv
from lct_gan_tpu_torch.sigproc.stft import reflect_pad

__all__ = ["PeriodDiscriminator", "MultiPeriodDiscriminator",
           "ScaleDiscriminator", "MultiScaleDiscriminator",
           "avg_pool1d_no_pad_count"]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class PeriodDiscriminator(nn.Module):
    """Period-P discriminator: right reflect-pad [B, T] to a multiple of P,
    view as [B, 1, T/P, P], five grouped (5, 1) convs with LeakyReLU
    (1 -> 32 -> 128 -> 512 -> 1024 -> 1024) and a (3, 1) post conv to 1."""

    CFGS = ((32, 5, 3, 1), (128, 5, 3, 4), (512, 5, 3, 16),
            (1024, 5, 3, 64), (1024, 5, 1, 64))  # (out, k, stride, groups)

    def __init__(self, period: int, use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.period = period
        conv = SNConv if use_spectral_norm else WNConv
        kw = dict(dtype=dtype, generator=generator)
        convs, cin = [], 1
        for out_ch, k, s, g in self.CFGS:
            convs.append(conv(cin, out_ch, (k, 1), (s, 1), (k // 2, 0),
                              groups=g, **kw))
            cin = out_ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(cin, 1, (3, 1), (1, 1), (1, 0), **kw)

    def forward(self, x: torch.Tensor, update_sn: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if x.ndim == 3:  # [B, 1, T]
            x = x[:, 0]
        B, T = x.shape
        P = self.period
        if T % P:
            x = reflect_pad(x, 0, P - T % P)
            T = x.shape[1]
        h = x.reshape(B, 1, T // P, P)
        fmaps = []
        for conv in self.convs:
            h = _leaky(conv(h, update_sn))
            fmaps.append(h)
        h = self.conv_post(h, update_sn).float()
        fmaps.append(h)
        return h, fmaps


class MultiPeriodDiscriminator(nn.Module):
    """MPD over periods (2, 3, 5, 7, 11): (logits list, fmaps lists)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, use_spectral_norm, dtype, generator)
            for p in periods)

    def forward(self, x: torch.Tensor, update_sn: bool = False):
        outs = [d(x, update_sn) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


def avg_pool1d_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(kernel 4, stride 2, padding 2, count_include_pad=False) on
    [B, C, T] (the JAX package's `_avg_pool1d_no_pad_count`)."""
    return F.avg_pool1d(x, 4, 2, 2, count_include_pad=False)


class ScaleDiscriminator(nn.Module):
    """One scale: six grouped 1-D convs with LeakyReLU (1 -> 16 -> 64 ->
    256 -> 1024 -> 1024 -> 1024) and a 3-tap post conv to 1."""

    CFGS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
            (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))

    def __init__(self, use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        conv = SNConv if use_spectral_norm else WNConv
        kw = dict(dtype=dtype, generator=generator)
        convs, cin = [], 1
        for out_ch, k, s, g in self.CFGS:
            convs.append(conv(cin, out_ch, (k,), (s,), (k // 2,), groups=g,
                              **kw))
            cin = out_ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(cin, 1, (3,), (1,), (1,), **kw)

    def forward(self, x: torch.Tensor, update_sn: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = x[:, None] if x.ndim == 2 else x   # [B, 1, T]
        fmaps = []
        for conv in self.convs:
            h = _leaky(conv(h, update_sn))
            fmaps.append(h)
        h = self.conv_post(h, update_sn).float()
        fmaps.append(h)
        return h, fmaps


class MultiScaleDiscriminator(nn.Module):
    """MSD over 3 scales, AvgPool1d(4, 2, 2) between scales; spectral norm
    on scale 0 only, when asked."""

    def __init__(self, num_scales: int = 3, use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(use_spectral_norm and i == 0, dtype, generator)
            for i in range(num_scales))

    def forward(self, x: torch.Tensor, update_sn: bool = False):
        h = x[:, None] if x.ndim == 2 else x
        logits, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                h = avg_pool1d_no_pad_count(h)
            out, fm = d(h, update_sn)
            logits.append(out)
            fmaps.append(fm)
        return logits, fmaps

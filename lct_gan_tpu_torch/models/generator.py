"""LCT generator and waveform enhancer (`lct_gan_tpu/models/generator.py`).

U-Net encoder/decoder over (time, freq) with three FTF bottleneck blocks
(GRUf1 -> GRUt1 -> GRUf2), predicting a compressed TF mask. Parameter and
buffer names are the reference state_dict's (`gen.conv1.weight`,
`gen.GRUt1.gru1.weight_ih_l0`, `gen.GRUf1.attn.in_proj_weight`, ...,
`stft.window`), so the reference-format checkpoint loads with strict=True.

Layouts at the public functions are the JAX package's: waveforms [B, T],
noisy_mag and mask [B, 1, F, T], FTF blocks [B, T, F, C]. The convolutions
run in NCHW with H = time, W = frequency (the reference's geometry).

Every FTF block with L <= 512 goes through `fused_ftf_block` (the CUDA kernel
on the card); a longer time block takes the composed path: LayerNorm and the
grouped GRU in one f32 operator (`fused_grouped_gru`, the CUDA kernels on the
card) -> LayerNorm -> MultiHeadSelfAttention (the MHSA kernel up to L = 1024,
the banded one from BANDED_KERNEL_MIN_SEQ with a band) -> Linear ->
LeakyReLU, as in the JAX package.

On the card the kernels serve a bottleneck of enc_channels[-1] channels in
any num_heads and gru_groups that divide it whose padded layout (each head
and group widened to a power of two) fits 512 channels (the widest
kernel, the FTF backward's too), and train the same layouts
(`ops/library.py::card_takes`): `check_card_widths` refuses anything else
before a model runs or trains there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lct_gan_tpu_torch.models.attention import MultiHeadSelfAttention
from lct_gan_tpu_torch.models.gru import GRUGroup, stack_groups
from lct_gan_tpu_torch.models.layers import LayerNorm
from lct_gan_tpu_torch.ops.ftf import MAX_FTF_SEQ, fused_ftf_block
from lct_gan_tpu_torch.ops.gru import fused_grouped_gru
from lct_gan_tpu_torch.ops.library import check_kernel_widths
from lct_gan_tpu_torch.sigproc import (STFTConfig, apply_mask, hann_window,
                                       istft, magnitude, stft)
from lct_gan_tpu_torch.utils.device import disable_tf32

__all__ = [
    "LCTGeneratorConfig",
    "check_card_widths",
    "FreqGRUBlock",
    "TimeGRUBlock",
    "TorchConvTranspose",
    "LctGenerator",
    "LctEnhancer",
]


@dataclasses.dataclass(frozen=True)
class LCTGeneratorConfig:
    """The JAX package's LCTGeneratorConfig (num_heads, gru_groups and
    max_time_context are honoured)."""

    in_channels: int = 1
    out_channels: int = 1
    enc_channels: Tuple[int, int, int] = (16, 32, 64)
    dec_channels: Tuple[int, int, int] = (64, 32, 16)
    num_heads: int = 4
    gru_groups: int = 4
    max_time_context: Optional[int] = None
    output_activation: str = "sigmoid"


def check_card_widths(cfg: LCTGeneratorConfig, device, *,
                      training: bool) -> None:
    """Raise unless the CUDA kernels run `cfg` on `device`, decided from the
    device argument alone (no card is queried): a bottleneck of
    enc_channels[-1] channels in num_heads heads and gru_groups groups that
    divide it, whose padded layout fits the widest kernel
    (`ops/library.py::card_takes`): 512 channels, for serving and with
    `training` alike (the FTF backward kernel's widest is 512 too). The
    message names
    enc_channels, --num_heads and --gru_groups and the width the layout
    must fit. Nothing is refused on the CPU, whose plain path takes every
    width."""
    if torch.device(device).type != "cuda":
        return
    check_kernel_widths("the CUDA path", cfg.enc_channels[-1],
                        num_heads=cfg.num_heads, groups=cfg.gru_groups,
                        training=training,
                        names=("enc_channels[-1]", "--num_heads",
                               "--gru_groups"),
                        hint=("; train this configuration with --device cpu"
                              if training else
                              "; run this configuration with device='cpu'"))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


class _FTFBlock(nn.Module):
    """Parameters and dispatch shared by the frequency and time blocks."""

    bidirectional: bool

    def __init__(self, channels: int, num_heads: int, groups: int,
                 precise: bool):
        super().__init__()
        C = channels
        self.num_heads = num_heads
        self.groups = groups
        self.precise = precise
        self.layernorm1 = LayerNorm(C)
        self.layernorm2 = LayerNorm(C)
        for g in range(groups):
            setattr(self, f"gru{g + 1}",
                    GRUGroup(C // groups, self.bidirectional))
        self.attn = MultiHeadSelfAttention(C, num_heads)
        self.lin = nn.Linear(2 * C if self.bidirectional else C, C)

    def kernel_params(self):
        """The block's parameters in `fused_ftf_block`'s order and layouts:
        (ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale, ln2_bias,
        in_w, in_b, out_w, out_b, lin_w, lin_b)."""
        gru = stack_groups([getattr(self, f"gru{g + 1}")
                            for g in range(self.groups)])
        return (self.layernorm1.weight, self.layernorm1.bias, *gru,
                self.layernorm2.weight, self.layernorm2.bias,
                *self.attn.kernel_params(), self.lin.weight.t(),
                self.lin.bias)

    def _sequences(self, seq: torch.Tensor, lookback: Optional[int] = None,
                   key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block over seq [N, L, C]."""
        N, L, C = seq.shape
        params = self.kernel_params()
        if L <= MAX_FTF_SEQ:
            return fused_ftf_block(
                seq, *params, bidirectional=self.bidirectional,
                num_heads=self.num_heads, lookback=lookback,
                key_bias=key_bias, precise=self.precise)
        # Composed path: LN1 and the GRU, the counterpart of the JAX
        # package's lax.scan, f32 in every mode.
        seq_gru = fused_grouped_gru(seq, *params[:6],
                                    bidirectional=self.bidirectional)
        seq = seq + seq_gru
        attn_out = self.attn(self.layernorm2(seq), lookback=lookback,
                             key_bias=key_bias, precise=self.precise)
        combined = (torch.cat([seq_gru, attn_out], dim=-1)
                    if self.bidirectional else attn_out)
        return seq + _leaky(self.lin(combined))


class FreqGRUBlock(_FTFBlock):
    """Frequency block over [B, T, F, C]: bidirectional GRU over frequency,
    Linear(2C -> C) on concat(gru, attn)."""

    bidirectional = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, F_, C = x.shape
        return self._sequences(x.reshape(B * T, F_, C)).reshape(B, T, F_, C)


class TimeGRUBlock(_FTFBlock):
    """Time block over [B, T, F, C]: causal GRU over time, optionally banded
    attention, Linear(C -> C) on the attention output."""

    bidirectional = False

    def __init__(self, channels: int, num_heads: int, groups: int,
                 precise: bool, max_time_context: Optional[int] = None):
        super().__init__(channels, num_heads, groups, precise)
        self.max_time_context = max_time_context

    def forward(self, x: torch.Tensor,
                frames_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames_valid: optional [B] count of time frames each row's
        attention keys may see (padded frames of bucketed batches are
        hidden from every query)."""
        B, T, F_, C = x.shape
        seq = x.permute(0, 2, 1, 3).reshape(B * F_, T, C)
        key_bias = None
        if frames_valid is not None:
            pos = torch.arange(T, device=x.device)
            kb = torch.where(pos[None, :] < frames_valid[:, None], 0.0, -1e30)
            # Row layout is b*F + f: repeat each batch row F times.
            key_bias = kb.to(torch.float32).repeat_interleave(F_, dim=0)
        out = self._sequences(seq, self.max_time_context, key_bias)
        return out.reshape(B, F_, T, C).permute(0, 2, 1, 3)


def TorchConvTranspose(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """The decoder's transposed conv: kernel (2, 3) over (T, F), stride
    (1, 2), padding (1, 1), output_padding (0, 1) -- torch geometry, which
    the JAX package reproduces with a dilated conv."""
    return nn.ConvTranspose2d(in_ch, out_ch, (2, 3), stride=(1, 2),
                              padding=(1, 1), output_padding=(0, 1))


def _align(a: torch.Tensor, b: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop two NCHW maps to the same (T, F)."""
    Tm = min(a.shape[2], b.shape[2])
    Fm = min(a.shape[3], b.shape[3])
    return a[:, :, :Tm, :Fm], b[:, :, :Tm, :Fm]


class LctGenerator(nn.Module):
    """noisy_mag [B, 1, F, T] -> mask_c [B, 1, F, T] (in [0, 1] with the
    sigmoid output)."""

    def __init__(self, cfg: LCTGeneratorConfig = LCTGeneratorConfig(),
                 precise: bool = False):
        super().__init__()
        self.cfg = cfg
        e1, e2, e3 = cfg.enc_channels
        d3, d2, d1 = cfg.dec_channels
        cin = cfg.in_channels
        conv_kw = dict(kernel_size=(2, 3), stride=(1, 2), padding=(1, 1))
        self.conv1 = nn.Conv2d(cin, e1, **conv_kw)
        self.conv2 = nn.Conv2d(e1, e2, **conv_kw)
        self.conv3 = nn.Conv2d(e2, e3, **conv_kw)
        self.skip2 = nn.Conv2d(cin, e3, 1)
        self.skip3 = nn.Conv2d(cin, e2, 1)
        self.skip4 = nn.Conv2d(cin, e1, 1)
        self.layernorm = LayerNorm(e3)
        block_kw = dict(channels=e3, num_heads=cfg.num_heads,
                        groups=cfg.gru_groups, precise=precise)
        self.GRUf1 = FreqGRUBlock(**block_kw)
        self.GRUt1 = TimeGRUBlock(max_time_context=cfg.max_time_context,
                                  **block_kw)
        self.GRUf2 = FreqGRUBlock(**block_kw)
        self.deconv2 = TorchConvTranspose(d3, d2)
        self.deconv3 = TorchConvTranspose(d2, d1)
        self.deconv4 = TorchConvTranspose(d1, cfg.out_channels)

    def forward(self, noisy_mag: torch.Tensor,
                frames_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames_valid [B]: valid input frames per row (bucketed batches).
        The encoder is stride 1 in time and each level grows T by one frame,
        so the last valid input frame reaches bottleneck frame
        frames_valid + 3 - 1: the time attention's keys are masked from
        frames_valid + 3 on."""
        if noisy_mag.ndim != 4 or noisy_mag.shape[1] != 1:
            raise ValueError("Expected noisy_mag [B, 1, F, T], got "
                             f"{tuple(noisy_mag.shape)}")
        x = noisy_mag.permute(0, 1, 3, 2)          # [B, 1, T, F]
        T_in, F_in = x.shape[2], x.shape[3]
        skip2, skip3, skip4 = self.skip2(x), self.skip3(x), self.skip4(x)
        x1 = _leaky(self.conv1(x))
        x2 = _leaky(self.conv2(x1))
        x3 = _leaky(self.conv3(x2))

        h = self.layernorm(x3.permute(0, 2, 3, 1))  # NHWC [B, T, F, C]
        h = self.GRUf1(h)
        bottleneck_valid = None
        if frames_valid is not None:
            bottleneck_valid = frames_valid + len(self.cfg.enc_channels)
        h = self.GRUt1(h, frames_valid=bottleneck_valid)
        h = self.GRUf2(h)
        h = h.permute(0, 3, 1, 2)                    # NCHW

        skip2_a, h_a = _align(skip2, h)
        y2 = _leaky(self.deconv2(h_a + skip2_a))
        skip3_a, y2_a = _align(skip3, y2)
        y3 = _leaky(self.deconv3(y2_a + skip3_a))
        skip4_a, y3_a = _align(skip4, y3)
        y4 = torch.relu(self.deconv4(y3_a + skip4_a))

        # Crop / zero-pad back to [T_in, F_in].
        T_out, F_out = y4.shape[2], y4.shape[3]
        y4 = y4[:, :, :T_in, :F_in]
        pad_t, pad_f = max(0, T_in - T_out), max(0, F_in - F_out)
        if pad_t or pad_f:
            y4 = F.pad(y4, (0, pad_f, 0, pad_t))
        out = y4.permute(0, 1, 3, 2)                 # [B, 1, F, T]
        if self.cfg.output_activation == "sigmoid":
            # After the zero-pad, like the reference: padded frames get 0.5.
            out = torch.sigmoid(out)
        return out


class LctEnhancer(nn.Module):
    """noisy waveform [B, T] (+ optional per-row `lengths`) ->
    (enhanced waveform [B, T], mask_c [B, 1, F, N_frames]).

    precise=False (the default) runs the kernels' GEMMs with bf16 operands
    as the TPU kernels do; precise=True keeps them in f32."""

    def __init__(self, gen_cfg: LCTGeneratorConfig = LCTGeneratorConfig(),
                 c: float = 0.3, stft_cfg: STFTConfig = STFTConfig(n_fft=512),
                 precise: bool = False):
        super().__init__()
        # The port's convs and matmuls stay in full f32 on the card: no TF32.
        disable_tf32()
        self.c = c
        self.stft_cfg = stft_cfg.finalize()
        self.gen = LctGenerator(gen_cfg, precise=precise)
        # The reference registers torch.hann_window(n_fft) as `stft.window`;
        # kept as a persistent buffer so its state_dict loads strictly.
        self.stft = nn.Module()
        self.stft.register_buffer("window", hann_window(self.stft_cfg.n_fft))

    def _reflect_tails(self, wave: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        """Continue each row past its valid end with the reflection its
        exact-length STFT would see: wave[b, L_b + k] = wave[b, L_b - 2 - k]
        (index clamped at 0) for k < n_fft // 2, so a bucketed row's
        boundary frames equal its exact-length run's."""
        B, T = wave.shape
        W = self.stft_cfg.n_fft // 2
        if T < W:
            return wave
        k = torch.arange(W, device=wave.device)
        src = (lengths[:, None] - 2 - k[None, :]).clamp(0, T - 1)
        tails = torch.gather(wave, 1, src)
        padded = F.pad(wave, (0, W))
        padded = padded.scatter(1, lengths[:, None] + k[None, :], tails)
        return padded[:, :T]

    def forward(self, noisy_wave: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if noisy_wave.ndim != 2:
            raise ValueError("Expected noisy_wave [B, T], got "
                             f"{tuple(noisy_wave.shape)}")
        cfg = self.stft_cfg
        if lengths is not None:
            lengths = lengths.to(device=noisy_wave.device, dtype=torch.long)
            if cfg.center and cfg.pad_mode == "reflect":
                noisy_wave = self._reflect_tails(noisy_wave, lengths)
        noisy_stft = stft(noisy_wave, cfg)               # [B, F, N]
        noisy_mag = magnitude(noisy_stft)[:, None]       # [B, 1, F, N]
        frames_valid = None
        if lengths is not None:
            pad = cfg.n_fft // 2 if cfg.center else 0
            frames_valid = 1 + torch.div(lengths + 2 * pad - cfg.n_fft,
                                         cfg.hop_length, rounding_mode="floor")
        mask_c = self.gen(noisy_mag, frames_valid=frames_valid)
        if frames_valid is not None:
            # Invalid frames' mask values are garbage (their queries see
            # masked keys): zero them so each row's OLA tail is silence.
            n_frames = mask_c.shape[-1]
            valid = (torch.arange(n_frames, device=mask_c.device)[None, :]
                     < frames_valid[:, None]).to(mask_c.dtype)
            mask_c = mask_c * valid[:, None, None, :]
        enhanced_stft = apply_mask(noisy_stft, mask_c, compressed=True,
                                   c=self.c)
        enhanced = istft(enhanced_stft, cfg, length=noisy_wave.shape[-1])
        return enhanced, mask_c

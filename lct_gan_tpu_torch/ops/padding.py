"""Zero padding that carries any bottleneck width C, split into any
num_heads attention heads and G GRU groups, to the CUDA kernels, which run
at a power of two: the kernel width CK = `kernel_width(C, num_heads, G)`.

A library built for the kernel width CK (`ops/_build.py`, -DLCT_C=<CK>; CK
in 16, 32, 64, 128, 256, 512, the FTF backward's in 16 .. 256) takes the
true C, the head count and the score scale at run time, and divides every LayerNorm by the true C (`csrc/common.cuh`).
The wrappers widen what they hand it:

  * each GRU group of gw channels to gw' = the next power of two, so group
    g's channels sit at [g gw', g gw' + gw) of the CK-wide rows and the
    CK / gw' groups (the last ones all zero) pack into the kernels' slots;
  * each attention head of hd channels to hd' = `head_width(hd)`, its q, k
    and v at [h hd', h hd' + hd) of each CK-wide section, the heads past
    num_heads all zero; the kernels take the true head's score scale,
    `score_scale(hd)`.

So CK is the smallest power of two, at least 16 (the kernels' narrowest
tile), that holds C, G gw' and num_heads hd': G gw' and num_heads hd' may
pass the next power of two above C (C = 50 in 5 groups or heads of 10 needs
80 channels, so runs at 128). The FTF block takes one CK for its GRU and
its attention; the composed path's GRU (groups only) and attention (heads
only) each take their own, as the tensors between them are unpadded.

Exact in both modes: a zero channel adds 0 to every product and every
LayerNorm sum, a GRU unit with zero weights and biases stays 0 (r = z =
1/2, n = tanh(0) = 0), and a zero head's context is 0 whatever its
probabilities. The padded output channels come out 0 and are dropped.

The backward (`ops/ftf_bwd.py`) takes the same padded operands, the
forward's padded hiddens (0 on every padded unit) and the cotangent padded
with zeros, and gathers the 15 gradients back to the true channels with
the inverse of each `pad_*` (`unpad_*`: every true entry from the one place
its pad put it, the rest dropped). That is exact: each pad places every
true entry at one position with weight 1 and fixes the others at 0, so the
gradient of the true block is the padded block's gradient read at those
positions; and nothing leaks from a padded position into a true one. A
padded channel's cotangent and weights are 0, so its products add 0 to
every true gradient; a padded GRU unit's dh (nonzero: it carries the
LayerNorm backward's value there, bounded, as r = z = 1/2 and n = 0 keep
its factors finite) reaches a true unit only through W_hh and W_ih entries
that are 0; the LayerNorm backward's means run over the C true channels,
where a padded channel's scale, and so its term, is 0. The padded
positions' own dx and gradients are the dropped part.

Where CK = C (C a power of two from 16, so every divisor is too) nothing
moves: `channel_map` and `head_map` return None and the wrappers hand the
tensors over as they are.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["MIN_KERNEL_WIDTH", "layout_width", "kernel_width", "head_width",
           "score_scale", "channel_map", "head_map", "padded_groups",
           "pad_last", "pad_gru", "pad_ln", "pad_in_proj", "pad_out_proj",
           "pad_lin", "unpad_last", "unpad_gru", "unpad_ln", "unpad_in_proj",
           "unpad_out_proj", "unpad_lin"]

# The narrowest kernel width: one 16-column tensor-core tile.
MIN_KERNEL_WIDTH = 16


def _pow2_ceil(v: int) -> int:
    return 1 << (int(v) - 1).bit_length()


def head_width(hd: int) -> int:
    """The width a head (or GRU group) of hd channels runs at: the next
    power of two (csrc/common.cuh's head_width)."""
    return _pow2_ceil(hd)


@functools.lru_cache(maxsize=None)
def layout_width(C: int, num_heads: int = 1, groups: int = 1) -> int:
    """Channels the padded layout of C channels in num_heads heads and
    `groups` GRU groups spans: the widest of C, the groups widened to
    powers of two and the heads widened alike."""
    return max(C, groups * head_width(C // groups),
               num_heads * head_width(C // num_heads))


@functools.lru_cache(maxsize=None)
def kernel_width(C: int, num_heads: int = 1, groups: int = 1) -> int:
    """The kernel width CK that C channels in num_heads heads and `groups`
    GRU groups run at: the padded layout rounded up to a power of two, at
    least MIN_KERNEL_WIDTH (the library's -DLCT_C, csrc/common.cuh)."""
    return max(MIN_KERNEL_WIDTH,
               _pow2_ceil(layout_width(C, num_heads, groups)))


@functools.lru_cache(maxsize=None)
def score_scale(hd: int) -> float:
    """The attention's score scale for heads of hd true channels, as the
    kernels take it: the f32 rounding of 1 / sqrt(hd), the JAX package's
    `1.0 / float(np.sqrt(hd))` applied to f32 scores."""
    return float(np.float32(1.0 / np.sqrt(hd)))


@functools.lru_cache(maxsize=None)
def _map(C: int, parts: int, width: int) -> Optional[torch.Tensor]:
    if width == C:
        return None
    step = C // parts
    idx = torch.arange(C)
    return (idx // step) * head_width(step) + idx % step


def channel_map(C: int, groups: int,
                width: Optional[int] = None) -> Optional[torch.Tensor]:
    """Where each of the C true channels sits in a `width`-wide row (default:
    the GRU's own kernel width) when the GRU runs `groups` groups (a
    LongTensor [C] on the CPU), or None when the row is C wide (nothing
    moves)."""
    return _map(C, groups, width or kernel_width(C, groups=groups))


def head_map(C: int, num_heads: int,
             width: Optional[int] = None) -> Optional[torch.Tensor]:
    """Where each of the C channels of q (or k, v, the context) sits in a
    `width`-wide section (default: the attention's own kernel width) when
    the attention runs `num_heads` heads, or None."""
    return _map(C, num_heads, width or kernel_width(C, num_heads=num_heads))


def padded_groups(C: int, groups: int, width: Optional[int] = None) -> int:
    """The GRU group count of the padded rows, `width` / gw' (default: the
    GRU's own kernel width)."""
    return ((width or kernel_width(C, groups=groups))
            // head_width(C // groups))


def _on(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return idx.to(t.device)


def pad_last(t: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """t [..., C] as [..., width], t's channels at `idx`, zeros elsewhere."""
    out = t.new_zeros((*t.shape[:-1], width))
    return out.index_copy_(-1, _on(idx, t), t)


def pad_ln(scale: torch.Tensor, bias: torch.Tensor, idx: torch.Tensor,
           width: int):
    return pad_last(scale, idx, width), pad_last(bias, idx, width)


def pad_gru(w_ih, w_hh, b_ih, b_hh, C: int, width: Optional[int] = None):
    """G groups' weights [D, G, gw, 3gw] / [D, G, 3gw] as the padded groups'
    [D, G', gw', 3gw'] / [D, G', 3gw'] of a `width`-wide row (default: the
    GRU's own kernel width): each group's inputs and units (per gate)
    widened with zeros, the groups past G zero."""
    D, G, gw, _ = w_ih.shape
    G2, gw2 = padded_groups(C, G, width), head_width(gw)

    def mat(w):
        out = w.new_zeros((D, G2, gw2, 3, gw2))
        out[:, :G, :gw, :, :gw] = w.reshape(D, G, gw, 3, gw)
        return out.reshape(D, G2, gw2, 3 * gw2)

    def vec(b):
        out = b.new_zeros((D, G2, 3, gw2))
        out[:, :G, :, :gw] = b.reshape(D, G, 3, gw)
        return out.reshape(D, G2, 3 * gw2)

    return mat(w_ih), mat(w_hh), vec(b_ih), vec(b_hh)


def pad_in_proj(in_w: torch.Tensor, in_b: torch.Tensor,
                rows: torch.Tensor, heads: torch.Tensor, width: int):
    """in_w [C, 3C], in_b [3C] as [CK, 3CK], [3CK]: input rows at `rows`,
    each of the q, k, v sections' columns at `heads`."""
    C = in_w.shape[0]
    cols = torch.cat([heads + s * width for s in range(3)])
    w = in_w.new_zeros((C, 3 * width)).index_copy_(1, _on(cols, in_w), in_w)
    w = pad_last(w.t(), rows, width).t().contiguous()
    return w, pad_last(in_b, cols, 3 * width)


def pad_out_proj(out_w: torch.Tensor, out_b: torch.Tensor,
                 heads: torch.Tensor, cols: torch.Tensor, width: int):
    """out_w [C, C] (context rows, channel columns), out_b [C] as [CK, CK],
    [CK]: rows at `heads`, columns at `cols`."""
    w = pad_last(out_w, cols, width)
    w = pad_last(w.t(), heads, width).t().contiguous()
    return w, pad_last(out_b, cols, width)


def pad_lin(lin_w: torch.Tensor, lin_b: torch.Tensor, idx: torch.Tensor,
            width: int):
    """lin_w [k C, C] (k = 2: g then the attention; or 1), lin_b [C] as
    [k CK, CK], [CK], every C-block of rows and the columns at `idx`."""
    C = lin_w.shape[1]
    k = lin_w.shape[0] // C
    rows = torch.cat([idx + i * width for i in range(k)])
    w = pad_last(lin_w, idx, width)
    w = pad_last(w.t(), rows, k * width).t().contiguous()
    return w, pad_last(lin_b, idx, width)


# The inverses, for gradients: each returns the true entries of a padded
# tensor from where the matching pad_* put them (the padded ones dropped).

def unpad_last(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [..., width] -> [..., C]: the channels at `idx`."""
    return t.index_select(-1, _on(idx, t))


def unpad_ln(dscale: torch.Tensor, dbias: torch.Tensor, idx: torch.Tensor):
    return unpad_last(dscale, idx), unpad_last(dbias, idx)


def unpad_gru(dw_ih, dw_hh, db_ih, db_hh, C: int, groups: int):
    """pad_gru's inverse: [D, G', gw', 3gw'] / [D, G', 3gw'] -> the G =
    `groups` groups' [D, G, gw, 3gw] / [D, G, 3gw] (gw = C / G)."""
    D, G2, gw2, _ = dw_ih.shape
    gw = C // groups

    def mat(w):
        return w.reshape(D, G2, gw2, 3, gw2)[:, :groups, :gw, :, :gw] \
            .reshape(D, groups, gw, 3 * gw)

    def vec(b):
        return b.reshape(D, G2, 3, gw2)[:, :groups, :, :gw].reshape(
            D, groups, 3 * gw)

    return mat(dw_ih), mat(dw_hh), vec(db_ih), vec(db_hh)


def unpad_in_proj(din_w: torch.Tensor, din_b: torch.Tensor,
                  rows: torch.Tensor, heads: torch.Tensor, width: int):
    """pad_in_proj's inverse: [CK, 3CK], [3CK] -> [C, 3C], [3C]."""
    cols = _on(torch.cat([heads + s * width for s in range(3)]), din_w)
    w = din_w.index_select(0, _on(rows, din_w)).index_select(1, cols)
    return w, din_b.index_select(0, cols)


def unpad_out_proj(dout_w: torch.Tensor, dout_b: torch.Tensor,
                   heads: torch.Tensor, cols: torch.Tensor):
    """pad_out_proj's inverse: [CK, CK], [CK] -> [C, C], [C]."""
    w = dout_w.index_select(0, _on(heads, dout_w)).index_select(
        1, _on(cols, dout_w))
    return w, unpad_last(dout_b, cols)


def unpad_lin(dlin_w: torch.Tensor, dlin_b: torch.Tensor, idx: torch.Tensor,
              width: int):
    """pad_lin's inverse: [k CK, CK], [CK] -> [k C, C], [C]."""
    k = dlin_w.shape[0] // width
    rows = _on(torch.cat([idx + i * width for i in range(k)]), dlin_w)
    w = dlin_w.index_select(0, rows).index_select(1, _on(idx, dlin_w))
    return w, unpad_last(dlin_b, idx)

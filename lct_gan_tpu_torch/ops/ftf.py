"""The whole FTF transformer block as one call, forward and backward.

    pre-LN -> grouped GRU (+residual) -> pre-LN -> 4-head self-attention
    -> Linear -> LeakyReLU(0.2) (+residual)

over x [N, L, C=64]: the frequency blocks (bidirectional GRU, Linear [2C, C]
on concat(gru, attn)) and the time block (causal GRU, Linear [C, C] on the
attention, optional band and per-key bias).

`fused_ftf_block` replaces the TPU kernel `lct_gan_tpu/ops/ftf.py::
_ftf_kernel` (API `fused_ftf_block`, :511) for L <= 512. On a CUDA tensor it
launches the hand-written kernels of `csrc/ftf.cu` (their bound on the H100
and what the simple design does about it are noted there); on a CPU tensor
it computes `ftf_block_reference`, its plain PyTorch version, which rounds
at the kernel's points unless precise=True.

It is differentiable (`FusedFTFFunction`, the JAX package's custom VJP,
`lct_gan_tpu/ops/ftf.py:450-504`): under grad the forward keeps the
per-direction GRU hiddens the kernel writes anyway, and the backward is
`ops/ftf_bwd.py::fused_ftf_bwd` (the CUDA backward kernel on the card, its
plain version on the CPU). A call with `key_bias` instead recomputes through
the f32 `ftf_block_reference` under autograd, as the JAX package does.

Parameter layouts are the JAX package's: GRU [D, G, H, 3H] / [D, G, 3H],
in_w [C, 3C], out_w [C, C], lin_w [2C or C, C].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lct_gan_tpu_torch.ops.attention import mhsa_reference
from lct_gan_tpu_torch.ops.gru import grouped_gru_hidden, round_bf16

__all__ = ["fused_ftf_block", "ftf_block_reference", "ftf_forward_with_hidden",
           "FusedFTFFunction", "layer_norm", "MAX_FTF_SEQ"]

# Longest sequence the fused block serves; longer time blocks take the
# composed path (models/generator.py), as in the JAX package.
MAX_FTF_SEQ = 512


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax LayerNorm math (fast-variance form) over the last axis."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _ftf_attention(n2, in_w, in_b, out_w, out_b, num_heads, lookback,
                   key_bias, precise):
    """The FTF kernel's attention: like mhsa_reference, but with its own
    bf16 rounding points (qkv stored bf16; the UNnormalised probabilities
    rounded, the context divided by (sum + 1e-20) and rounded)."""
    if precise:
        return mhsa_reference(n2, in_w, in_b, out_w, out_b,
                              num_heads=num_heads, lookback=lookback,
                              key_bias=key_bias, precise=True)
    B, S, E = n2.shape
    hd = E // num_heads
    qkv = round_bf16(round_bf16(n2) @ round_bf16(in_w) + in_b)
    q, k, v = (t.reshape(B, S, num_heads, hd).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / float(hd) ** 0.5)
    if lookback is not None:
        pos = torch.arange(S, device=n2.device)
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] >= pos[:, None] - lookback)
        scores = scores.masked_fill(~band, float("-inf"))
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True) + 1e-20
    ctx = (round_bf16(p) @ v) / denom
    ctx = ctx.transpose(1, 2).reshape(B, S, E)
    return round_bf16(ctx) @ round_bf16(out_w) + out_b


def ftf_block_reference(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh,
                        ln2_scale, ln2_bias, in_w, in_b, out_w, out_b,
                        lin_w, lin_b, *, bidirectional: bool,
                        num_heads: int = 4, lookback: Optional[int] = None,
                        key_bias: Optional[torch.Tensor] = None,
                        precise: bool = True, return_hidden: bool = False):
    """Plain FTF block over x [N, L, C] -> [N, L, C] f32.

    precise=True is all f32 (the JAX `ftf_block_reference`); precise=False
    rounds every GEMM operand to bf16 where the TPU kernel does (n1, W_ih;
    h, W_hh; n2, in_w; qkv; p, v; ctx, out_w; g, a, lin_w).
    return_hidden=True also returns the per-direction GRU hiddens
    [D, N*L, C] (the backward's `hid`, in the CUDA kernel's layout)."""
    N, L, C = x.shape
    rnd = (lambda t: t) if precise else round_bf16
    x = x.to(torch.float32)
    n1 = layer_norm(x, ln1_scale, ln1_bias)
    hid = grouped_gru_hidden(n1, w_ih, w_hh, b_ih, b_hh,
                             bidirectional=bidirectional, precise=precise)
    g = hid.sum(dim=0)
    s = x + g
    n2 = layer_norm(s, ln2_scale, ln2_bias)
    a = _ftf_attention(n2, in_w, in_b, out_w, out_b, num_heads, lookback,
                       key_bias, precise)
    if lin_w.shape[0] == 2 * C:
        comb = rnd(g) @ rnd(lin_w[:C]) + rnd(a) @ rnd(lin_w[C:]) + lin_b
    else:
        comb = rnd(a) @ rnd(lin_w) + lin_b
    comb = torch.where(comb >= 0, comb, 0.2 * comb)
    out = s + comb
    if return_hidden:
        return out, hid.reshape(hid.shape[0], N * L, C)
    return out


_P = ctypes.c_void_p
_FTF_ARGTYPES = ([_P] * 21 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                 + [_P])


def check_kernel_shapes(name: str, x, w_ih, lin_w, num_heads: int,
                        bidirectional: bool) -> None:
    """Raise unless the FTF kernels (forward and backward) take these
    shapes: C = 64, 4 heads, 4 GRU groups of 16, L <= 512, lin_w rows
    matching the block type."""
    N, L, C = x.shape
    if C != 64 or num_heads != 4 or tuple(w_ih.shape[1:]) != (4, 16, 48):
        raise ValueError(f"{name} kernel takes C=64, 4 heads and 4 GRU "
                         "groups of 16")
    if L > MAX_FTF_SEQ:
        raise ValueError(f"{name} kernel takes L <= {MAX_FTF_SEQ}, got {L}")
    if lin_w.shape[0] != (2 * C if bidirectional else C):
        raise ValueError(f"lin_w rows {lin_w.shape[0]} do not match "
                         f"bidirectional={bidirectional}")


def ftf_forward_with_hidden(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh,
                            ln2_scale, ln2_bias, in_w, in_b, out_w, out_b,
                            lin_w, lin_b, *, bidirectional: bool,
                            num_heads: int = 4,
                            lookback: Optional[int] = None,
                            key_bias: Optional[torch.Tensor] = None,
                            precise: bool = False):
    """The FTF block forward and the per-direction GRU hiddens:
    (out [N, L, 64], hid [D, N*L, 64]), both f32, hid unrounded.

    CPU tensors: `ftf_block_reference(..., return_hidden=True)`. CUDA
    tensors: the kernels of csrc/ftf.cu (`hid` is the scratch their GRU
    stage writes), each call counted in `fused_ftf_block.launches`."""
    if x.device.type == "cpu":
        return ftf_block_reference(
            x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale,
            ln2_bias, in_w, in_b, out_w, out_b, lin_w, lin_b,
            bidirectional=bidirectional, num_heads=num_heads,
            lookback=lookback, key_bias=key_bias, precise=precise,
            return_hidden=True)
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    if x.device.type != "cuda":
        raise ValueError(f"fused_ftf_block: unsupported device {x.device}")
    check_kernel_shapes("fused_ftf_block", x, w_ih, lin_w, num_heads,
                        bidirectional)
    N, L, C = x.shape
    D = 2 if bidirectional else 1
    lin_in = lin_w.shape[0]
    dev = x.device
    f = f32_operand
    ops = [f("x", x, (N, L, C), dev),
           f("ln1_scale", ln1_scale, (C,), dev),
           f("ln1_bias", ln1_bias, (C,), dev),
           f("w_ih", w_ih, (D, 4, 16, 48), dev),
           f("w_hh", w_hh, (D, 4, 16, 48), dev),
           f("b_ih", b_ih, (D, 4, 48), dev),
           f("b_hh", b_hh, (D, 4, 48), dev),
           f("ln2_scale", ln2_scale, (C,), dev),
           f("ln2_bias", ln2_bias, (C,), dev),
           f("in_w", in_w, (C, 3 * C), dev),
           f("in_b", in_b, (3 * C,), dev),
           f("out_w", out_w, (C, C), dev),
           f("out_b", out_b, (C,), dev),
           f("lin_w", lin_w, (lin_in, C), dev),
           f("lin_b", lin_b, (C,), dev),
           None if key_bias is None
           else f("key_bias", key_bias, (N, L), dev)]
    rows = N * L
    scratch = [torch.empty(shape, device=dev, dtype=torch.float32)
               for shape in ((rows, D * 3 * C),    # xp
                             (D, rows, C),         # hid
                             (rows, 3 * C),        # qkv
                             (rows, C))]           # ctx
    out = torch.empty((N, L, C), device=dev, dtype=torch.float32)
    fn = kernel_function("ftf", "lct_ftf_forward", _FTF_ARGTYPES)
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             *(t.data_ptr() for t in scratch), out.data_ptr(),
             N, L, D, lin_in, -1 if lookback is None else int(lookback),
             int(bool(precise)),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "ftf", "fused_ftf_block kernel launch")
    fused_ftf_block.launches += 1
    return out, scratch[1]


class FusedFTFFunction(torch.autograd.Function):
    """Autograd for the FTF block (`lct_gan_tpu/ops/ftf.py:450-504`).

    apply(keep_hidden, bidirectional, num_heads, lookback, precise,
          key_bias, x, *14 params). With keep_hidden (some input needs a
    gradient) the forward saves its inputs and the per-direction hiddens;
    without it nothing extra is kept. key_bias is a constant (no gradient).
    """

    @staticmethod
    def forward(ctx, keep_hidden, bidirectional, num_heads, lookback,
                precise, key_bias, x, *params):
        out, hid = ftf_forward_with_hidden(
            x, *params, bidirectional=bidirectional, num_heads=num_heads,
            lookback=lookback, key_bias=key_bias, precise=precise)
        ctx.cfg = (bidirectional, num_heads, lookback, precise)
        if keep_hidden:
            if key_bias is None:
                ctx.save_for_backward(x, *params, hid)
            else:
                # The backward kernel has no key-bias input: recompute
                # (lct_gan_tpu/ops/ftf.py:468-472, 490-497).
                ctx.save_for_backward(x, *params, key_bias)
            ctx.has_key_bias = key_bias is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        bidirectional, num_heads, lookback, precise = ctx.cfg
        saved = ctx.saved_tensors
        if ctx.has_key_bias:
            *primals, key_bias = saved
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_() for t in primals]
                out = ftf_block_reference(
                    *inputs, bidirectional=bidirectional,
                    num_heads=num_heads, lookback=lookback,
                    key_bias=key_bias, precise=True)
                grads = torch.autograd.grad(out, inputs, dout)
        else:
            from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

            *primals, hid = saved
            grads = fused_ftf_bwd(
                *primals, hid, dout.contiguous(), bidirectional=bidirectional,
                num_heads=num_heads, lookback=lookback, precise=precise)
        return (None, None, None, None, None, None) + tuple(grads)


def fused_ftf_block(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh,
                    ln2_scale, ln2_bias, in_w, in_b, out_w, out_b,
                    lin_w, lin_b, *, bidirectional: bool,
                    num_heads: int = 4, lookback: Optional[int] = None,
                    key_bias: Optional[torch.Tensor] = None,
                    precise: bool = False) -> torch.Tensor:
    """Fused FTF block over x [N, L, 64] -> [N, L, 64] f32 (L <= 512).

    CPU tensors: `ftf_block_reference(..., precise=precise)`. CUDA tensors:
    the kernels of csrc/ftf.cu, each call counted in
    `fused_ftf_block.launches`. key_bias: optional [N, L] per-key additive
    bias (0 / -1e30); lookback: optional inclusive causal band.
    Differentiable in x and every parameter (`FusedFTFFunction`)."""
    params = (ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale,
              ln2_bias, in_w, in_b, out_w, out_b, lin_w, lin_b)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x,) + params)
    return FusedFTFFunction.apply(keep, bidirectional, num_heads, lookback,
                                  precise, key_bias, x, *params)


fused_ftf_block.launches = 0

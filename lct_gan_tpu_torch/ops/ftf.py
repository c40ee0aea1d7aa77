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
at the kernel's points unless precise=True. The kernel is the
`torch.library` operator `lct_gan_tpu_torch::fused_ftf_block` (`ftf_op`,
-> (out, hid), `ops/library.py`): every mode is an argument and a fake
implementation gives the output shapes, so `torch.export` traces it as one
node.

It is differentiable (the op's autograd, the JAX package's custom VJP,
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
from typing import Optional, Tuple

import torch

from lct_gan_tpu_torch.ops.attention import kernel_design, mhsa_reference
from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
from lct_gan_tpu_torch.ops.gru import grouped_gru_hidden, round_bf16
from lct_gan_tpu_torch.ops.library import define_op

__all__ = ["fused_ftf_block", "ftf_block_reference", "ftf_forward_with_hidden",
           "ftf_op", "ftf_plain", "layer_norm", "ftf_scratch",
           "check_kernel_shapes", "MAX_FTF_SEQ"]

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
# lct_ftf_forward_bf16 / _f32: 16 inputs (key_bias may be null), the four
# scratch slots of ftf_scratch (gb may be null), out; N; L, D, lin_in,
# lookback, device; stream.
_FTF_ARGTYPES = [_P] * 21 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [_P]


def ftf_scratch(rows: int, D: int, lin_in: int, precise: bool):
    """(name, shape, dtype) of each scratch tensor the kernels of one mode
    write, in the C entry point's order. bf16 (csrc/ftf.cu, tensor cores):
    the per-direction hiddens, q, k, v as bf16 (the contract rounds them),
    s = x + g (f32) and, for the frequency block's Linear (lin_in = 128),
    bf16(g), else None (a null pointer): the only values the attention
    kernel's epilogue reads besides q, k, v. precise (CUDA cores, all f32):
    the GRU input projection, the hiddens, qkv and the attention context."""
    C = 64
    hid = ("hid", (D, rows, C), torch.float32)
    if precise:
        return [("xp", (rows, D * 3 * C), torch.float32), hid,
                ("qkv", (rows, 3 * C), torch.float32),
                ("ctx", (rows, C), torch.float32)]
    return [hid, ("qkv", (rows, 3 * C), torch.bfloat16),
            ("s", (rows, C), torch.float32),
            ("gb", (rows, C), torch.bfloat16) if lin_in == 2 * C else None]


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


def ftf_plain(x: torch.Tensor, ln1_scale: torch.Tensor,
               ln1_bias: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               b_ih: torch.Tensor, b_hh: torch.Tensor, ln2_scale: torch.Tensor,
               ln2_bias: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
               out_w: torch.Tensor, out_b: torch.Tensor, lin_w: torch.Tensor,
               lin_b: torch.Tensor, key_bias: Optional[torch.Tensor],
               bidirectional: bool, num_heads: int, lookback: Optional[int],
               precise: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op on the CPU, and its decomposition in a portable export."""
    return ftf_block_reference(
        x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale, ln2_bias,
        in_w, in_b, out_w, out_b, lin_w, lin_b, bidirectional=bidirectional,
        num_heads=num_heads, lookback=lookback, key_bias=key_bias,
        precise=precise, return_hidden=True)


def _ftf_fake(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale,
              ln2_bias, in_w, in_b, out_w, out_b, lin_w, lin_b, key_bias,
              bidirectional, num_heads, lookback, precise):
    if x.device.type == "cuda":
        check_kernel_shapes("fused_ftf_block", x, w_ih, lin_w, num_heads,
                            bidirectional)
    N, L, C = x.shape
    D = w_ih.shape[0] if bidirectional else 1
    return (x.new_empty((N, L, C), dtype=torch.float32),
            x.new_empty((D, N * L, C), dtype=torch.float32))


def _ftf_cuda(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale,
              ln2_bias, in_w, in_b, out_w, out_b, lin_w, lin_b, key_bias,
              bidirectional, num_heads, lookback, precise):
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

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
    specs = ftf_scratch(N * L, D, lin_in, precise)
    scratch = [torch.empty(spec[1], device=dev, dtype=spec[2])
               if spec else None for spec in specs]
    out = torch.empty((N, L, C), device=dev, dtype=torch.float32)
    entry = "lct_ftf_forward_f32" if precise else "lct_ftf_forward_bf16"
    fn = kernel_function("ftf", entry, _FTF_ARGTYPES)
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             *(None if t is None else t.data_ptr()
               for t in scratch), out.data_ptr(),
             N, L, D, lin_in, -1 if lookback is None else lookback,
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "ftf", "fused_ftf_block kernel launch")
    fused_ftf_block.launches += 1
    fused_ftf_block.design = kernel_design(precise)
    return out, next(t for spec, t in zip(specs, scratch)
                     if spec and spec[0] == "hid")


def _ftf_setup_context(ctx, inputs, output):
    """Under grad the forward keeps its inputs and the per-direction
    hiddens (`lct_gan_tpu/ops/ftf.py:450-504`); with key_bias, which the
    backward kernel does not take, its inputs and key_bias for a recompute
    (:468-472, 490-497). `hid` gets no gradient (nor a zero tensor for
    one: the backward only ever has `out`'s)."""
    primals, (key_bias, bidirectional, num_heads, lookback, precise) = (
        inputs[:15], inputs[15:])
    ctx.cfg = (bidirectional, num_heads, lookback, precise)
    ctx.has_key_bias = key_bias is not None
    ctx.save_for_backward(*primals,
                          output[1] if key_bias is None else key_bias)
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)


def _ftf_backward(ctx, dout, _dhid):
    bidirectional, num_heads, lookback, precise = ctx.cfg
    *primals, last = ctx.saved_tensors
    if ctx.has_key_bias:
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in primals]
            out = ftf_block_reference(
                *inputs, bidirectional=bidirectional, num_heads=num_heads,
                lookback=lookback, key_bias=last, precise=True)
            grads = torch.autograd.grad(out, inputs, dout)
    else:
        grads = fused_ftf_bwd(*primals, last, dout.contiguous(),
                              bidirectional=bidirectional,
                              num_heads=num_heads, lookback=lookback,
                              precise=precise)
    return (*grads, None, None, None, None, None)


# The operator -> (out, hid).
ftf_op = define_op("fused_ftf_block", ftf_plain, _ftf_cuda, _ftf_fake)
torch.library.register_autograd(ftf_op, _ftf_backward,
                                setup_context=_ftf_setup_context)


def ftf_forward_with_hidden(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh,
                            ln2_scale, ln2_bias, in_w, in_b, out_w, out_b,
                            lin_w, lin_b, *, bidirectional: bool,
                            num_heads: int = 4,
                            lookback: Optional[int] = None,
                            key_bias: Optional[torch.Tensor] = None,
                            precise: bool = False):
    """The FTF block forward and the per-direction GRU hiddens:
    (out [N, L, 64], hid [D, N*L, 64]), both f32, hid unrounded: the op
    `torch.ops.lct_gan_tpu_torch.fused_ftf_block`.

    CPU tensors: `ftf_block_reference(..., return_hidden=True)`. CUDA
    tensors: the kernels of csrc/ftf.cu (`hid` is the scratch their GRU
    stage writes), each launch counted in `fused_ftf_block.launches`, from
    an exported program too. Differentiable in `out` (x and every
    parameter): under grad the backward is `ops/ftf_bwd.py::fused_ftf_bwd`
    on the saved hiddens, or, with key_bias, the f32 recompute."""
    return ftf_op(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale,
                  ln2_bias, in_w, in_b, out_w, out_b, lin_w, lin_b, key_bias,
                  bool(bidirectional), int(num_heads),
                  None if lookback is None else int(lookback), bool(precise))


def fused_ftf_block(x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh,
                    ln2_scale, ln2_bias, in_w, in_b, out_w, out_b,
                    lin_w, lin_b, *, bidirectional: bool,
                    num_heads: int = 4, lookback: Optional[int] = None,
                    key_bias: Optional[torch.Tensor] = None,
                    precise: bool = False) -> torch.Tensor:
    """Fused FTF block over x [N, L, 64] -> [N, L, 64] f32 (L <= 512).

    CPU tensors: `ftf_block_reference(..., precise=precise)`. CUDA tensors:
    the kernels of csrc/ftf.cu, each launch counted in
    `fused_ftf_block.launches`. key_bias: optional [N, L] per-key additive
    bias (0 / -1e30); lookback: optional inclusive causal band.
    Differentiable in x and every parameter (`ftf_forward_with_hidden`)."""
    return ftf_forward_with_hidden(
        x, ln1_scale, ln1_bias, w_ih, w_hh, b_ih, b_hh, ln2_scale, ln2_bias,
        in_w, in_b, out_w, out_b, lin_w, lin_b, bidirectional=bidirectional,
        num_heads=num_heads, lookback=lookback, key_bias=key_bias,
        precise=precise)[0]


fused_ftf_block.launches = 0
fused_ftf_block.design = None   # kernel design of the last launch

"""The whole FTF transformer block as one call, forward and backward.

    pre-LN -> grouped GRU (+residual) -> pre-LN -> multi-head attention
    -> Linear -> LeakyReLU(0.2) (+residual)

over x [N, L, C]: the frequency blocks (bidirectional GRU, Linear [2C, C]
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
in_w [C, 3C], out_w [C, C], lin_w [2C or C, C]. The forward and backward
kernels take every C in any num_heads and any G that divide C whose padded
layout fits the widest kernel (`ops/library.py::card_takes`: channels,
heads and groups zero-padded to the kernel width of 16 .. 512, forward
and backward alike, exact: `ops/padding.py`); a call on the card at other
widths raises before any launch, under grad too (there at the backward's
widths).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.attention import (BLOCK_WIDTHS, kernel_design,
                                             mhsa_reference)
from lct_gan_tpu_torch.ops.ftf_bwd import check_backward_shapes, fused_ftf_bwd
from lct_gan_tpu_torch.ops.gru import (grouped_gru_hidden, layer_norm,
                                       pack_gru_slots, round_bf16)
from lct_gan_tpu_torch.ops.library import check_kernel_widths, define_op

__all__ = ["fused_ftf_block", "ftf_block_reference", "ftf_forward_with_hidden",
           "ftf_op", "ftf_plain", "ftf_scratch", "kernel_operands",
           "check_kernel_shapes", "MAX_FTF_SEQ"]

# Longest sequence the fused block serves; longer time blocks take the
# composed path (models/generator.py), as in the JAX package.
MAX_FTF_SEQ = 512


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
# lct_ftf_forward_bf16 / _f32 by mode (precise): 16 inputs (the GRU's in
# pack_gru_slots' layout; key_bias may be null), the scratch slots of
# ftf_scratch (bf16: six, gb may be null, xp null but for the GRU slots on
# CUDA cores, ctx null below kernel width 256; f32: four), out; N; L, D,
# lin_in, lookback; the widths (BLOCK_WIDTHS: the true C, num_heads, the
# score scale, GRU slots); device; stream.
_FTF_ARGTYPES = {
    precise: [_P] * (21 if precise else 23) + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + BLOCK_WIDTHS + [ctypes.c_int, _P]
    for precise in (False, True)}


def ftf_scratch(rows: int, D: int, lin_in: int, precise: bool, C: int = 64,
                slots: int = 0):
    """(name, shape, dtype) of each scratch tensor the kernels of one mode
    write, in the C entry point's order, for the kernels' width C (a power
    of two). bf16 (csrc/ftf.cu, tensor cores): the per-direction hiddens,
    q, k, v as bf16 (the contract rounds them), s = x + g (f32) and, for the
    frequency block's Linear (lin_in = 2C), bf16(g), else None (a null
    pointer): the only values the attention kernel's epilogue reads besides
    q, k, v; at C = 128 with one dense GRU slot (`slots` = 1) also the GRU
    input projection, which that slot's CUDA-core recurrence reads. At C >=
    256 always six entries: those four, xp where the slots are wider than
    16 (else None; 6.7 GB at C = 512 at the frequency block's main shape)
    and the attention's context as bf16, which the split epilogue reads. precise (CUDA cores, all f32): the GRU input
    projection, the hiddens, qkv and the attention context. No head count
    changes the sizes."""
    hid = ("hid", (D, rows, C), torch.float32)
    xp = ("xp", (rows, D * 3 * C), torch.float32)
    if precise:
        return [xp, hid, ("qkv", (rows, 3 * C), torch.float32),
                ("ctx", (rows, C), torch.float32)]
    out = [hid, ("qkv", (rows, 3 * C), torch.bfloat16),
           ("s", (rows, C), torch.float32),
           ("gb", (rows, C), torch.bfloat16) if lin_in == 2 * C else None]
    if C > 128:
        return out + [xp if slots < C // 16 else None,
                      ("ctx", (rows, C), torch.bfloat16)]
    return out + ([xp] if C > 64 and slots == 1 else [])


def check_kernel_shapes(name: str, x, w_ih, lin_w, num_heads: int,
                        bidirectional: bool) -> None:
    """Raise unless the FTF forward kernels take these shapes: C channels
    in num_heads heads and G GRU groups of C / G (w_ih [D, G, C / G, 3 * C /
    G]), each dividing C, whose padded layout fits the widest kernel
    (`ops/library.py::check_kernel_widths`), L <= 512, lin_w rows matching
    the block type."""
    N, L, C = x.shape
    G = w_ih.shape[1]
    check_kernel_widths(f"{name} kernel", C, num_heads=num_heads, groups=G)
    if tuple(w_ih.shape[1:]) != (G, C // G, 3 * (C // G)):
        raise ValueError(f"{name} kernel takes w_ih [D, {G}, {C // G}, "
                         f"{3 * (C // G)}], got {tuple(w_ih.shape)}")
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


def kernel_operands(ops, num_heads: int):
    """The FTF kernels' operands from the block's (x, the 14 parameters,
    key_bias): padded to the kernel width of C, num_heads and the G GRU
    groups with zero channels, units and heads where it is not C
    (`ops/padding.py`), then the GRU weights packed into slots. Returns
    (operands, cidx): cidx [C] the output channels that are the block's
    (None: all)."""
    C, G = ops[0].shape[-1], ops[3].shape[1]
    CK = padding.kernel_width(C, num_heads, G)
    cidx = padding.channel_map(C, G, CK)
    ops = list(ops)
    if cidx is not None:  # zero channels up to CK, exact
        hidx = padding.head_map(C, num_heads, CK)
        ops[:15] = [padding.pad_last(ops[0], cidx, CK),
                    *padding.pad_ln(*ops[1:3], cidx, CK),
                    *padding.pad_gru(*ops[3:7], C, CK),
                    *padding.pad_ln(*ops[7:9], cidx, CK),
                    *padding.pad_in_proj(*ops[9:11], cidx, hidx, CK),
                    *padding.pad_out_proj(*ops[11:13], hidx, cidx, CK),
                    *padding.pad_lin(*ops[13:15], cidx, CK)]
    ops[3:7] = pack_gru_slots(*ops[3:7])
    return ops, cidx


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
    G = w_ih.shape[1]
    H = C // G
    lin_in = lin_w.shape[0]
    dev = x.device
    CK = padding.kernel_width(C, num_heads, G)
    f = f32_operand
    ops = [f("x", x, (N, L, C), dev),
           f("ln1_scale", ln1_scale, (C,), dev),
           f("ln1_bias", ln1_bias, (C,), dev),
           f("w_ih", w_ih, (D, G, H, 3 * H), dev),
           f("w_hh", w_hh, (D, G, H, 3 * H), dev),
           f("b_ih", b_ih, (D, G, 3 * H), dev),
           f("b_hh", b_hh, (D, G, 3 * H), dev),
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
    ops, cidx = kernel_operands(ops, num_heads)
    slots = ops[3].shape[1]
    specs = ftf_scratch(N * L, D, lin_in // C * CK, precise, CK, slots)
    scratch = [torch.empty(spec[1], device=dev, dtype=spec[2])
               if spec else None for spec in specs]
    if not precise:
        scratch += [None] * (6 - len(scratch))  # no xp, no ctx
    out = torch.empty((N, L, CK), device=dev, dtype=torch.float32)
    entry = "lct_ftf_forward_f32" if precise else "lct_ftf_forward_bf16"
    fn = kernel_function("ftf", entry, _FTF_ARGTYPES[precise], CK)
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             *(None if t is None else t.data_ptr()
               for t in scratch), out.data_ptr(),
             N, L, D, lin_in // C * CK, -1 if lookback is None else lookback,
             C, num_heads, padding.score_scale(C // num_heads), slots,
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "ftf", "fused_ftf_block kernel launch", CK)
    fused_ftf_block.launches += 1
    fused_ftf_block.design = kernel_design(precise)
    hid = next(t for spec, t in zip(specs, scratch)
               if spec and spec[0] == "hid")
    if cidx is not None:
        cidx = cidx.to(dev)
        out, hid = out.index_select(-1, cidx), hid.index_select(-1, cidx)
    return out, hid


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
    (out [N, L, C], hid [D, N*L, C]), both f32, hid unrounded: the op
    `torch.ops.lct_gan_tpu_torch.fused_ftf_block`.

    CPU tensors: `ftf_block_reference(..., return_hidden=True)`. CUDA
    tensors: the kernels of csrc/ftf.cu (`hid` is the scratch their GRU
    stage writes), each launch counted in `fused_ftf_block.launches`, from
    an exported program too. Differentiable in `out` (x and every
    parameter): under grad the backward is `ops/ftf_bwd.py::fused_ftf_bwd`
    on the saved hiddens, or, with key_bias, the f32 recompute. On the
    card the backward kernel's widths are checked before the forward
    launches (`check_backward_shapes`: the widths the forward takes)."""
    if (x.device.type == "cuda" and key_bias is None
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, ln1_scale, ln1_bias, w_ih,
                                              w_hh, b_ih, b_hh, ln2_scale,
                                              ln2_bias, in_w, in_b, out_w,
                                              out_b, lin_w, lin_b))):
        check_backward_shapes("fused_ftf_block under grad", x, w_ih, lin_w,
                              num_heads, bidirectional)
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
    """Fused FTF block over x [N, L, C] -> [N, L, C] f32 (L <= 512).

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

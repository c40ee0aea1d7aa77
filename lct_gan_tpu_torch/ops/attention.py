"""Fused multi-head self-attention over many short sequences.

`fused_mhsa` replaces the TPU kernel `lct_gan_tpu/ops/attention.py::
_mhsa_kernel` (API `fused_mhsa`, :275): qkv projection -> per-head scores
with an optional inclusive causal band and a per-key bias -> softmax ->
context -> output projection, for x [N, L, E=64], L <= 1024. On a CUDA
tensor it launches the hand-written kernels of `csrc/mhsa.cu` (their bound
on the H100 and what the simple design does about it are noted there); on
a CPU tensor it computes `mhsa_reference`, its plain PyTorch version.

The kernel is the `torch.library` operator `lct_gan_tpu_torch::fused_mhsa`
(`mhsa_op`, `ops/library.py`): every mode is an argument, a fake
implementation gives its output shape, so `torch.export` traces it as one
node, and a program that holds the node launches the kernel on the card.

It is differentiable: the backward recomputes the f32 `mhsa_reference`
under autograd, as the JAX package's custom VJP does
(`lct_gan_tpu/ops/attention.py:244-269`); key_bias is a constant.

Parameter layout is the JAX package's: in_proj_kernel [E, 3E] (the
transpose of torch's in_proj_weight), out_proj_kernel [E, E].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lct_gan_tpu_torch.ops.gru import round_bf16
from lct_gan_tpu_torch.ops.library import define_op

__all__ = ["mhsa_reference", "fused_mhsa", "mhsa_op", "mhsa_plain",
           "MAX_PALLAS_SEQ", "register_recompute_backward",
           "check_attention_shapes", "kernel_design", "mhsa_scratch"]

# Longest sequence the fused kernel serves (the precise kernel's K/V
# shared-memory tile: 33 floats per key, 135 KB at 1024). Above it the
# unbanded time attention takes the plain path, as the JAX package's does.
MAX_PALLAS_SEQ = 1024


def mhsa_reference(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                   in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
                   out_proj_bias: torch.Tensor, num_heads: int = 4,
                   lookback: Optional[int] = None,
                   key_bias: Optional[torch.Tensor] = None, *,
                   precise: bool = True) -> torch.Tensor:
    """Plain MHSA (torch.nn.MultiheadAttention math) over x [B, S, E].

    lookback: keep keys in the inclusive band [t - lookback, t].
    key_bias: optional [B, S] additive score bias per key (0 / -1e30).
    precise=False rounds the GEMM operands to bf16 where the MHSA kernel
    does (x and in_proj; q, k, v; the normalised probabilities; the context
    and out_proj); precise=True is all f32 (the JAX `mhsa_reference`)."""
    B, S, E = x.shape
    nh = num_heads
    hd = E // nh
    rnd = (lambda t: t) if precise else round_bf16
    qkv = rnd(x.to(torch.float32)) @ rnd(in_proj_kernel) + in_proj_bias
    q, k, v = (rnd(t).reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    scores = (q @ k.transpose(-1, -2)) / float(hd) ** 0.5
    if lookback is not None:
        pos = torch.arange(S, device=x.device)
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] >= pos[:, None] - lookback)
        scores = scores.masked_fill(~band, float("-inf"))
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    attn = torch.softmax(scores, dim=-1)
    out = (rnd(attn) @ v).transpose(1, 2).reshape(B, S, E)
    return rnd(out) @ rnd(out_proj_kernel) + out_proj_bias


def register_recompute_backward(op, reference) -> None:
    """Autograd of an attention op (x, in_w, in_b, out_w, out_b, key_bias,
    num_heads, lookback, precise) whose backward differentiates its f32 plain
    version: the backward recomputes `reference(..., precise=True)` under
    autograd. key_bias is a constant (no gradient)."""

    def setup_context(ctx, inputs, output):
        x, in_w, in_b, out_w, out_b, key_bias, num_heads, lookback, _ = inputs
        ctx.save_for_backward(x, in_w, in_b, out_w, out_b, key_bias)
        ctx.cfg = (num_heads, lookback)

    def backward(ctx, dout):
        *primals, key_bias = ctx.saved_tensors
        num_heads, lookback = ctx.cfg
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in primals]
            out = reference(*inputs, num_heads=num_heads, lookback=lookback,
                            key_bias=key_bias, precise=True)
            grads = torch.autograd.grad(out, inputs, dout)
        return (*grads, None, None, None, None)

    torch.library.register_autograd(op, backward,
                                    setup_context=setup_context)


def kernel_design(precise: bool) -> str:
    """The kernel design a mode runs on the card (csrc/ftf.cu, mhsa.cu):
    bf16 operands on tensor cores, or all-f32 arithmetic on CUDA cores."""
    return "simt-f32" if precise else "tc-bf16"


def mhsa_scratch(rows: int, precise: bool):
    """(name, shape, dtype) of each scratch tensor the kernels of one mode
    write, in the C entry point's order: q, k, v as bf16 (the contract
    rounds them; the context never leaves the kernel), or, precise, qkv
    and the context in f32."""
    if not precise:
        return [("qkv", (rows, 192), torch.bfloat16)]
    return [("qkv", (rows, 192), torch.float32),
            ("ctx", (rows, 64), torch.float32)]


_P = ctypes.c_void_p
# lct_mhsa_forward_bf16 / _f32: 6 inputs (key_bias may be null), the
# scratch tensors of mhsa_scratch, out; N; L, lookback, device; stream.
_MHSA_ARGTYPES = {
    False: [_P] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_P],
    True: [_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_P]}


def check_attention_shapes(name: str, x: torch.Tensor, num_heads: int,
                           max_seq: Optional[int] = None) -> None:
    """Raise unless the attention kernels take these shapes: E = 64, 4
    heads and, for the MHSA kernel, L <= max_seq."""
    N, L, E = x.shape
    if E != 64 or num_heads != 4:
        raise ValueError(f"{name} kernel takes E=64 and 4 heads, got "
                         f"E={E}, num_heads={num_heads}")
    if max_seq is not None and L > max_seq:
        raise ValueError(f"{name} kernel takes L <= {max_seq}, got {L}")


def mhsa_plain(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
                out_proj_bias: torch.Tensor, key_bias: Optional[torch.Tensor],
                num_heads: int, lookback: Optional[int],
                precise: bool) -> torch.Tensor:
    """The op on the CPU, and its decomposition in a portable export."""
    return mhsa_reference(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                          out_proj_bias, num_heads=num_heads,
                          lookback=lookback, key_bias=key_bias,
                          precise=precise)


def _mhsa_fake(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
               out_proj_bias, key_bias, num_heads, lookback, precise):
    if x.device.type == "cuda":
        check_attention_shapes("fused_mhsa", x, num_heads, MAX_PALLAS_SEQ)
    return x.new_empty(x.shape, dtype=torch.float32)


def _mhsa_cuda(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
               out_proj_bias, key_bias, num_heads, lookback, precise):
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    check_attention_shapes("fused_mhsa", x, num_heads, MAX_PALLAS_SEQ)
    N, L, E = x.shape
    dev = x.device
    ops = [f32_operand("x", x, (N, L, E), dev),
           f32_operand("in_proj_kernel", in_proj_kernel, (E, 3 * E), dev),
           f32_operand("in_proj_bias", in_proj_bias, (3 * E,), dev),
           f32_operand("out_proj_kernel", out_proj_kernel, (E, E), dev),
           f32_operand("out_proj_bias", out_proj_bias, (E,), dev),
           None if key_bias is None
           else f32_operand("key_bias", key_bias, (N, L), dev)]
    scratch = [torch.empty(shape, device=dev, dtype=dtype)
               for _, shape, dtype in mhsa_scratch(N * L, precise)]
    out = torch.empty((N, L, E), device=dev, dtype=torch.float32)
    entry = "lct_mhsa_forward_f32" if precise else "lct_mhsa_forward_bf16"
    fn = kernel_function("mhsa", entry, _MHSA_ARGTYPES[precise])
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             *(t.data_ptr() for t in scratch), out.data_ptr(), N, L,
             -1 if lookback is None else lookback,
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "mhsa", "fused_mhsa kernel launch")
    fused_mhsa.launches += 1
    fused_mhsa.design = kernel_design(precise)
    return out


mhsa_op = define_op("fused_mhsa", mhsa_plain, _mhsa_cuda, _mhsa_fake)
register_recompute_backward(mhsa_op, mhsa_reference)


def fused_mhsa(x: torch.Tensor, in_proj_kernel: torch.Tensor,
               in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
               out_proj_bias: torch.Tensor, *, num_heads: int = 4,
               lookback: Optional[int] = None,
               key_bias: Optional[torch.Tensor] = None,
               precise: bool = False) -> torch.Tensor:
    """Fused MHSA over x [N, L, 64] -> [N, L, 64] f32 (4 heads, L <= 1024).

    The op `torch.ops.lct_gan_tpu_torch.fused_mhsa`. CPU tensors:
    `mhsa_reference(..., precise=precise)`. CUDA tensors: the kernels of
    csrc/mhsa.cu, each launch counted in `fused_mhsa.launches`, from an
    exported program too. Differentiable in x and the four parameters
    (`register_recompute_backward`)."""
    return mhsa_op(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                   out_proj_bias, key_bias, int(num_heads),
                   None if lookback is None else int(lookback),
                   bool(precise))


fused_mhsa.launches = 0
fused_mhsa.design = None   # kernel design of the last launch

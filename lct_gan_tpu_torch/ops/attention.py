"""Fused multi-head self-attention over many short sequences.

`fused_mhsa` replaces the TPU kernel `lct_gan_tpu/ops/attention.py::
_mhsa_kernel` (API `fused_mhsa`, :275): qkv projection -> per-head scores
with an optional inclusive causal band and a per-key bias -> softmax ->
context -> output projection, for x [N, L, E=64], L <= 1024. On a CUDA
tensor it launches the hand-written kernels of `csrc/mhsa.cu` (their bound
on the H100 and what the simple design does about it are noted there); on
a CPU tensor it computes `mhsa_reference`, its plain PyTorch version.

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

__all__ = ["mhsa_reference", "fused_mhsa", "MAX_PALLAS_SEQ",
           "RecomputeBackward"]

# Longest sequence the fused kernel serves (its K/V shared-memory tile:
# 33 floats per key, 135 KB at 1024). Above it the unbanded time attention
# takes the plain path, as the JAX package's does.
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


class RecomputeBackward(torch.autograd.Function):
    """Autograd for a kernel wrapper whose backward differentiates its f32
    plain version: apply(forward, reference, kwargs, key_bias, x, in_w,
    in_b, out_w, out_b). `forward(x, *params, key_bias=..., **kwargs)` runs
    the kernel (or the plain version on the CPU); the backward recomputes
    `reference(..., precise=True)` under autograd. key_bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, forward, reference, kwargs, key_bias, x, *params):
        ctx.reference, ctx.kwargs = reference, kwargs
        ctx.save_for_backward(x, *params,
                              *(() if key_bias is None else (key_bias,)))
        ctx.has_key_bias = key_bias is not None
        return forward(x, *params, key_bias=key_bias, **kwargs)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        key_bias = saved[-1] if ctx.has_key_bias else None
        primals = saved[:5]
        kwargs = {k: v for k, v in ctx.kwargs.items() if k != "precise"}
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in primals]
            out = ctx.reference(*inputs, key_bias=key_bias, precise=True,
                                **kwargs)
            grads = torch.autograd.grad(out, inputs, dout)
        return (None, None, None, None) + tuple(grads)


_P = ctypes.c_void_p
_MHSA_ARGTYPES = ([_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                  + [_P])


def _fused_mhsa_forward(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                        out_proj_bias, *, num_heads, lookback, key_bias,
                        precise):
    if x.device.type == "cpu":
        return mhsa_reference(x, in_proj_kernel, in_proj_bias,
                              out_proj_kernel, out_proj_bias,
                              num_heads=num_heads, lookback=lookback,
                              key_bias=key_bias, precise=precise)
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    if x.device.type != "cuda":
        raise ValueError(f"fused_mhsa: unsupported device {x.device}")
    N, L, E = x.shape
    if E != 64 or num_heads != 4:
        raise ValueError("fused_mhsa kernel takes E=64 and 4 heads, got "
                         f"E={E}, num_heads={num_heads}")
    if L > MAX_PALLAS_SEQ:
        raise ValueError(f"fused_mhsa kernel takes L <= {MAX_PALLAS_SEQ}, "
                         f"got {L}")
    dev = x.device
    ops = [f32_operand("x", x, (N, L, E), dev),
           f32_operand("in_proj_kernel", in_proj_kernel, (E, 3 * E), dev),
           f32_operand("in_proj_bias", in_proj_bias, (3 * E,), dev),
           f32_operand("out_proj_kernel", out_proj_kernel, (E, E), dev),
           f32_operand("out_proj_bias", out_proj_bias, (E,), dev),
           None if key_bias is None
           else f32_operand("key_bias", key_bias, (N, L), dev)]
    qkv = torch.empty((N * L, 3 * E), device=dev, dtype=torch.float32)
    ctx = torch.empty((N * L, E), device=dev, dtype=torch.float32)
    out = torch.empty((N, L, E), device=dev, dtype=torch.float32)
    fn = kernel_function("mhsa", "lct_mhsa_forward", _MHSA_ARGTYPES)
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(), N, L,
             -1 if lookback is None else int(lookback), int(bool(precise)),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "mhsa", "fused_mhsa kernel launch")
    fused_mhsa.launches += 1
    return out


def fused_mhsa(x: torch.Tensor, in_proj_kernel: torch.Tensor,
               in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
               out_proj_bias: torch.Tensor, *, num_heads: int = 4,
               lookback: Optional[int] = None,
               key_bias: Optional[torch.Tensor] = None,
               precise: bool = False) -> torch.Tensor:
    """Fused MHSA over x [N, L, 64] -> [N, L, 64] f32 (4 heads, L <= 1024).

    CPU tensors: `mhsa_reference(..., precise=precise)`. CUDA tensors: the
    kernels of csrc/mhsa.cu, each call counted in `fused_mhsa.launches`.
    Differentiable in x and the four parameters (`RecomputeBackward`)."""
    return RecomputeBackward.apply(
        _fused_mhsa_forward, mhsa_reference,
        dict(num_heads=num_heads, lookback=lookback, precise=precise),
        key_bias, x, in_proj_kernel, in_proj_bias, out_proj_kernel,
        out_proj_bias)


fused_mhsa.launches = 0

"""Banded-causal multi-head self-attention in O(S * W), any sequence length.

`banded_mhsa` replaces the TPU kernel `lct_gan_tpu/ops/banded_attention.py::
_banded_kernel` (API `banded_mhsa`, :274): qkv projection -> per-head scores
of each query q over the keys [q - W, q] of its inclusive causal band, plus
a per-key bias -> softmax -> context -> output projection, for x [N, S,
E=64] with no upper bound on S. On a CUDA tensor it launches the
hand-written kernels of `csrc/banded.cu` (their bound on the H100 and what
the simple design does about it are noted there); on a CPU tensor it
computes `banded_mhsa_reference`, its plain PyTorch version. The backward
recomputes the f32 `banded_mhsa_reference` under autograd (linear in S), as
the JAX package's custom VJP does (`lct_gan_tpu/ops/banded_attention.py:
243-268`); key_bias is a constant.

The plain version is the JAX package's two-key-block formulation
(`lct_gan_tpu/models/attention.py::_blocked_banded_attention`): queries in
tiles of W rows, each tile scoring keys of its own tile and the one before,
so memory and work are linear in S and no [S, S] tensor exists.

Parameter layout is the JAX package's: in_proj_kernel [E, 3E], out_proj_kernel
[E, E].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lct_gan_tpu_torch.ops.attention import RecomputeBackward
from lct_gan_tpu_torch.ops.gru import round_bf16

__all__ = ["banded_mhsa_reference", "banded_mhsa"]


def _blocked_banded_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lookback: int, key_bias: Optional[torch.Tensor],
                         rnd) -> torch.Tensor:
    """Banded-causal attention over q/k/v [B, nh, S, hd] (the JAX package's
    `_blocked_banded_attention`, models/attention.py:35-96). `rnd` rounds
    the normalised probabilities (bf16 mode) or is the identity."""
    B, nh, S, hd = q.shape
    W = max(int(lookback), 1)  # tile rows; the band itself is `lookback`
    n = -(-S // W)
    pad = n * W - S

    def blocks(t):  # [B, nh, S, hd] -> [B, nh, n, W, hd]
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
            B, nh, n, W, hd)

    def with_prev(t):  # key context of block i: [block i-1, block i]
        prev = torch.nn.functional.pad(t[:, :, :-1], (0, 0, 0, 0, 1, 0))
        return torch.cat([prev, t], dim=3)  # [B, nh, n, 2W, hd]

    qb = blocks(q)
    kc, vc = with_prev(blocks(k)), with_prev(blocks(v))
    scores = (qb @ kc.transpose(-1, -2)) / float(hd) ** 0.5

    # Query row a of block i (global iW + a) attends local key j (global
    # (i-1)W + j) iff a + W - lookback <= j <= a + W; keys outside [0, S)
    # are invalid. The self key (j == a + W) stays attendable so no row is
    # all -inf. (The JAX blocked path writes the band as a <= j, which is
    # the same for lookback >= 1 but keeps the key before the self key at
    # lookback = 0, where its masked path and its kernel keep the self key
    # alone; this follows the kernel.)
    dev = q.device
    a = torch.arange(W, device=dev)[:, None]
    j = torch.arange(2 * W, device=dev)[None, :]
    band = (j >= a + W - int(lookback)) & (j <= a + W)
    kpos = ((torch.arange(n, device=dev)[:, None] - 1) * W
            + torch.arange(2 * W, device=dev)[None, :])
    valid = (kpos >= 0) & (kpos < S)
    mask = (band[None] & valid[:, None, :]) | (j == a + W)[None]
    if key_bias is not None:
        kb = torch.nn.functional.pad(key_bias.to(torch.float32),
                                     (0, pad)).reshape(B, n, W)
        prev = torch.nn.functional.pad(kb[:, :-1], (0, 0, 1, 0))
        scores = scores + torch.cat([prev, kb], dim=2)[:, None, :, None, :]
    # -inf out of band, as the JAX reference fills: a row whose whole band
    # is key-masked (-1e30 + s == -1e30 in f32) comes out uniform over it.
    scores = scores.masked_fill(~mask, float("-inf"))
    out = rnd(torch.softmax(scores, dim=-1)) @ vc
    return out.reshape(B, nh, n * W, hd)[:, :, :S]


def banded_mhsa_reference(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                          in_proj_bias: torch.Tensor,
                          out_proj_kernel: torch.Tensor,
                          out_proj_bias: torch.Tensor, *, num_heads: int,
                          lookback: int,
                          key_bias: Optional[torch.Tensor] = None,
                          precise: bool = True) -> torch.Tensor:
    """Plain banded MHSA over x [B, S, E] in O(S * lookback) memory.

    Each query q attends keys [q - lookback, q] ∩ [0, S); key_bias is an
    optional [B, S] additive score bias per key (0 / -1e30). precise=False
    rounds to bf16 where the banded kernel does (x and in_proj; q, k, v; the
    normalised probabilities; the context and out_proj); precise=True is all
    f32 (the JAX `banded_mhsa_reference`)."""
    if lookback < 0:
        raise ValueError(f"lookback must be >= 0, got {lookback}")
    B, S, E = x.shape
    nh = num_heads
    hd = E // nh
    rnd = (lambda t: t) if precise else round_bf16
    qkv = rnd(x.to(torch.float32)) @ rnd(in_proj_kernel) + in_proj_bias
    q, k, v = (rnd(t).reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    ctx = _blocked_banded_core(q, k, v, lookback, key_bias, rnd)
    ctx = ctx.transpose(1, 2).reshape(B, S, E)
    return rnd(ctx) @ rnd(out_proj_kernel) + out_proj_bias


_P = ctypes.c_void_p
_BANDED_ARGTYPES = ([_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                    + [_P])


def _banded_mhsa_forward(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                         out_proj_bias, *, num_heads, lookback, key_bias,
                         precise):
    if x.device.type == "cpu":
        return banded_mhsa_reference(x, in_proj_kernel, in_proj_bias,
                                     out_proj_kernel, out_proj_bias,
                                     num_heads=num_heads, lookback=lookback,
                                     key_bias=key_bias, precise=precise)
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    if x.device.type != "cuda":
        raise ValueError(f"banded_mhsa: unsupported device {x.device}")
    N, S, E = x.shape
    if E != 64 or num_heads != 4:
        raise ValueError("banded_mhsa kernel takes E=64 and 4 heads, got "
                         f"E={E}, num_heads={num_heads}")
    dev = x.device
    ops = [f32_operand("x", x, (N, S, E), dev),
           f32_operand("in_proj_kernel", in_proj_kernel, (E, 3 * E), dev),
           f32_operand("in_proj_bias", in_proj_bias, (3 * E,), dev),
           f32_operand("out_proj_kernel", out_proj_kernel, (E, E), dev),
           f32_operand("out_proj_bias", out_proj_bias, (E,), dev),
           None if key_bias is None
           else f32_operand("key_bias", key_bias, (N, S), dev)]
    qkv = torch.empty((N * S, 3 * E), device=dev, dtype=torch.float32)
    ctx = torch.empty((N * S, E), device=dev, dtype=torch.float32)
    out = torch.empty((N, S, E), device=dev, dtype=torch.float32)
    fn = kernel_function("banded", "lct_banded_forward", _BANDED_ARGTYPES)
    err = fn(*(None if t is None else t.data_ptr() for t in ops),
             qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(), N, S,
             int(lookback), int(bool(precise)),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "banded", "banded_mhsa kernel launch")
    banded_mhsa.launches += 1
    return out


def banded_mhsa(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
                out_proj_bias: torch.Tensor, *, num_heads: int = 4,
                lookback: int, key_bias: Optional[torch.Tensor] = None,
                precise: bool = False) -> torch.Tensor:
    """Banded MHSA over x [N, S, 64] -> [N, S, 64] f32 (4 heads, any S).

    CPU tensors: `banded_mhsa_reference(..., precise=precise)`. CUDA
    tensors: the kernels of csrc/banded.cu, each call counted in
    `banded_mhsa.launches`. Differentiable in x and the four parameters
    (`RecomputeBackward`)."""
    if lookback < 0:
        raise ValueError(f"banded_mhsa: lookback must be >= 0, got {lookback}")
    return RecomputeBackward.apply(
        _banded_mhsa_forward, banded_mhsa_reference,
        dict(num_heads=num_heads, lookback=lookback, precise=precise),
        key_bias, x, in_proj_kernel, in_proj_bias, out_proj_kernel,
        out_proj_bias)


banded_mhsa.launches = 0

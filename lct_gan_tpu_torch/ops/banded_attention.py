"""Banded-causal multi-head self-attention in O(S * W), any sequence length.

`banded_mhsa` replaces the TPU kernel `lct_gan_tpu/ops/banded_attention.py::
_banded_kernel` (API `banded_mhsa`, :274): qkv projection -> per-head scores
of each query q over the keys [q - W, q] of its inclusive causal band, plus
a per-key bias -> softmax -> context -> output projection, for x [N, S,
E] (in any number of heads that divides E whose padded layout fits the
widest kernel, padded as `fused_mhsa` pads them) with no upper bound on S.
On a CUDA tensor it launches the
hand-written kernels of `csrc/banded.cu` (their bound on the H100 and what
each mode's design does about it are noted there): bf16 mode one fused
tensor-core pass for bands whose scores fit in registers (the library's
`lct_banded_max_register_lookback` keys back; none at kernel widths of
128, 256 and 512), and
the MHSA kernel's tensor-core design with the band above that; precise
mode three all-f32
CUDA-core kernels. On a CPU tensor it computes
`banded_mhsa_reference`, its plain PyTorch version. The kernel is the
`torch.library` operator `lct_gan_tpu_torch::banded_mhsa` (`banded_op`,
`ops/library.py`), every mode an argument, so `torch.export` traces it as
one node. The
backward recomputes the f32 `banded_mhsa_reference` under autograd (linear
in S), as the JAX package's custom VJP does (`lct_gan_tpu/ops/
banded_attention.py:243-268`); key_bias is a constant.

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

from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.attention import (ATTN_WIDTHS,
                                             check_attention_shapes,
                                             kernel_design, pad_attention,
                                             register_recompute_backward)
from lct_gan_tpu_torch.ops.gru import round_bf16
from lct_gan_tpu_torch.ops.library import define_op

__all__ = ["banded_mhsa_reference", "banded_mhsa", "banded_op",
           "banded_plain", "banded_scratch"]


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


def banded_scratch(rows: int, precise: bool, in_registers: bool = True,
                   C: int = 64):
    """(name, shape, dtype) of each scratch tensor the kernels of one mode
    write, in the C entry point's order: none for bf16 when the band's
    scores fit in registers (q, k, v and the context stay on the SM), q, k,
    v as bf16 for a wider band (`in_registers` false; every band at C >=
    128) and at C >= 256 the context as bf16 (the split epilogue reads it),
    and, precise, qkv and the context in f32 (C channels, any head
    count)."""
    if precise:
        return [("qkv", (rows, 3 * C), torch.float32),
                ("ctx", (rows, C), torch.float32)]
    if in_registers:
        return []
    return [("qkv", (rows, 3 * C), torch.bfloat16)] + (
        [("ctx", (rows, C), torch.bfloat16)] if C > 128 else [])


_P = ctypes.c_void_p
# The C entry point of csrc/banded.cu each mode launches, with its argtypes:
# 6 inputs (key_bias may be null), the scratch (bf16: qkv and ctx, each may
# be null; f32: qkv, ctx), out; N; S, lookback; the widths (E, num_heads,
# score scale); device; stream.
BANDED_ENTRY = {
    precise: ("lct_banded_forward_f32" if precise
              else "lct_banded_forward_bf16",
              [_P] * 9 + [ctypes.c_longlong]
              + [ctypes.c_int] * 2 + ATTN_WIDTHS + [ctypes.c_int, _P])
    for precise in (False, True)}


def banded_plain(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                  in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
                  out_proj_bias: torch.Tensor,
                  key_bias: Optional[torch.Tensor], num_heads: int,
                  lookback: int, precise: bool) -> torch.Tensor:
    """The op on the CPU, and its decomposition in a portable export."""
    return banded_mhsa_reference(x, in_proj_kernel, in_proj_bias,
                                 out_proj_kernel, out_proj_bias,
                                 num_heads=num_heads, lookback=lookback,
                                 key_bias=key_bias, precise=precise)


def _banded_fake(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                 out_proj_bias, key_bias, num_heads, lookback, precise):
    if x.device.type == "cuda":
        check_attention_shapes("banded_mhsa", x, num_heads)
    return x.new_empty(x.shape, dtype=torch.float32)


def _banded_cuda(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                 out_proj_bias, key_bias, num_heads, lookback, precise):
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    check_attention_shapes("banded_mhsa", x, num_heads)
    N, S, E = x.shape
    dev = x.device
    ops = [f32_operand("x", x, (N, S, E), dev),
           f32_operand("in_proj_kernel", in_proj_kernel, (E, 3 * E), dev),
           f32_operand("in_proj_bias", in_proj_bias, (3 * E,), dev),
           f32_operand("out_proj_kernel", out_proj_kernel, (E, E), dev),
           f32_operand("out_proj_bias", out_proj_bias, (E,), dev),
           None if key_bias is None
           else f32_operand("key_bias", key_bias, (N, S), dev)]
    ops, padded = pad_attention(ops, num_heads)
    EK = ops[0].shape[-1]
    # The library owns the widest band its fused bf16 kernel serves.
    max_reg_w = kernel_function("banded", "lct_banded_max_register_lookback",
                                [], EK)()
    scratch = [torch.empty(shape, device=dev, dtype=dtype) for _, shape, dtype
               in banded_scratch(N * S, precise, lookback <= max_reg_w, EK)]
    slots = [t.data_ptr() for t in scratch]
    slots += [None] * (2 - len(slots))
    out = torch.empty((N, S, EK), device=dev, dtype=torch.float32)
    fn = kernel_function("banded", *BANDED_ENTRY[precise], EK)
    err = fn(*(None if t is None else t.data_ptr() for t in ops), *slots,
             out.data_ptr(), N, S, lookback, E, num_heads,
             padding.score_scale(E // num_heads),
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "banded", "banded_mhsa kernel launch", EK)
    banded_mhsa.launches += 1
    banded_mhsa.design = kernel_design(precise)
    return out[..., :E].contiguous() if padded else out


banded_op = define_op("banded_mhsa", banded_plain, _banded_cuda,
                      _banded_fake)
register_recompute_backward(banded_op, banded_mhsa_reference)


def banded_mhsa(x: torch.Tensor, in_proj_kernel: torch.Tensor,
                in_proj_bias: torch.Tensor, out_proj_kernel: torch.Tensor,
                out_proj_bias: torch.Tensor, *, num_heads: int = 4,
                lookback: int, key_bias: Optional[torch.Tensor] = None,
                precise: bool = False) -> torch.Tensor:
    """Banded MHSA over x [N, S, E] -> [N, S, E] f32 (num_heads dividing
    E, their padded layout within the widest kernel, any S).

    The op `torch.ops.lct_gan_tpu_torch.banded_mhsa`. CPU tensors:
    `banded_mhsa_reference(..., precise=precise)`. CUDA tensors: the
    kernels of csrc/banded.cu, each launch counted in
    `banded_mhsa.launches` (from an exported program too) and its design
    recorded in `banded_mhsa.design`. Differentiable in x and the four
    parameters (`register_recompute_backward`)."""
    if lookback < 0:
        raise ValueError(f"banded_mhsa: lookback must be >= 0, got {lookback}")
    return banded_op(x, in_proj_kernel, in_proj_bias, out_proj_kernel,
                     out_proj_bias, key_bias, int(num_heads), int(lookback),
                     bool(precise))


banded_mhsa.launches = 0
banded_mhsa.design = None   # kernel design of the last launch

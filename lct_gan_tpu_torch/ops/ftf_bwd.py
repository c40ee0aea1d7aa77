"""The FTF block's backward pass as one call.

`fused_ftf_bwd` replaces the TPU kernel `lct_gan_tpu/ops/ftf_bwd.py::
_ftf_bwd_kernel` (API `fused_ftf_bwd`, :440): from the forward's inputs, its
per-direction GRU hiddens and the output cotangent it returns dx and the 14
parameter gradients, without re-running the forward recurrence:

  * recompute LN2 -> qkv -> attention (normalised p), the combine layer;
  * LeakyReLU, Linear, out-proj backward; softmax VJP
    ds = p * (dp - rowsum(dp * p)); qkv projection and LN2 backward;
  * recompute LN1 -> xp and, from the time-shifted saved hiddens, hp; the
    gate algebra as per-step factors K1..K5 in one vectorised pass;
  * BPTT  dh_{t-1} = dh_t * z_t + (dh_t * K123_t) @ W_hh^T  per direction;
  * the GRU weight and bias gradients and the LN1 backward after the loop.

On a CUDA tensor it launches the hand-written kernels of `csrc/ftf_bwd.cu`
(their bound on the H100 and what each design does about it are noted
there): in bf16 mode the tensor-core design (`lct_ftf_backward_bf16`, design
tag `tc-bf16`), in precise mode the all-f32 CUDA-core one
(`lct_ftf_backward_f32`, `simt-f32`), at every C in any number of heads
and GRU groups that divides C whose padded layout fits its widest kernel
width, 512 (`check_backward_shapes`, `ops/library.py::check_kernel_widths`
with `training`; each
kernel width's library built at its first backward, `ops/_build.py`). The
wrapper hands the kernels the forward's operands (`ops/ftf.py::
kernel_operands`: zero-padded to the block's kernel width where it is not
C, the GRU weights packed into the kernels' slots), the hiddens and the
cotangent
padded alike, and takes the gradients apart again
(`ops/gru.py::unpack_gru_slot_grads`, then the inverses of the pads,
`ops/padding.py::unpad_*`; exact, as that module says). On a CPU tensor it
computes
`ftf_bwd_reference`, its plain PyTorch version: the same hand-derived
backward, rounding every GEMM operand to bf16 where the TPU kernel does (its
`cd` casts, :144-148) unless precise=True. The kernel is the `torch.library`
operator `lct_gan_tpu_torch::fused_ftf_bwd` (`ftf_bwd_op`, `ops/library.py`),
every mode an argument; it runs as the FTF operator's backward
(`ops/ftf.py`).

Layouts are the JAX package's, except `hid`, which is the CUDA forward
kernel's [D, N*L, C] (the JAX kernel's [N, L, D*C] transposed). GRU
gradients come back grouped, [D, G, H, 3H] / [D, G, 3H].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.attention import BLOCK_WIDTHS, kernel_design
from lct_gan_tpu_torch.ops.gru import (gru_slot, round_bf16,
                                       unpack_gru_slot_grads)
from lct_gan_tpu_torch.ops.library import check_kernel_widths, define_op

__all__ = ["fused_ftf_bwd", "ftf_bwd_reference", "ftf_bwd_op",
           "ftf_bwd_plain", "ftf_bwd_scratch_bytes", "check_backward_shapes",
           "true_gradients"]


def _ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-6):
    """(y, xhat, rstd) of the fast-variance LayerNorm over the last axis."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x - mu) * rstd
    return xhat * scale + bias, xhat, rstd


def _ln_bwd(dy, xhat, rstd, scale):
    """dx of y = xhat * scale + bias (means over the feature axis)."""
    dxh = dy * scale
    return rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                   - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))


def ftf_bwd_reference(x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b,
                      in_w, in_b, out_w, out_b, lin_w, lin_b, hid, dout, *,
                      bidirectional: bool, num_heads: int = 4,
                      lookback: Optional[int] = None,
                      precise: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain FTF block backward. x, dout [N, L, C]; hid [D, N*L, C].

    Returns (dx, dln1s, dln1b, dw_ih, dw_hh, db_ih, db_hh, dln2s, dln2b,
    din_w, din_b, dout_w, dout_b, dlin_w, dlin_b), all f32, in the primal
    arguments' shapes (the order of the JAX `fused_ftf_bwd`)."""
    N, L, C = x.shape
    D, G, H, _ = w_ih.shape
    D = 2 if bidirectional else 1
    nh = num_heads
    hd = C // nh
    rows = N * L
    rnd = (lambda t: t) if precise else round_bf16
    f32 = torch.float32
    xf = x.to(f32).reshape(rows, C)
    do = dout.to(f32).reshape(rows, C)
    hid = hid.to(f32).reshape(D, rows, C)

    # ---- recompute LN2 -> qkv -> attention (normalised p, ctx) ----
    g = hid.sum(dim=0)
    s = xf + g
    n2, xh2, rs2 = _ln_fwd(s, ln2s, ln2b)
    qkv = rnd(rnd(n2) @ rnd(in_w) + in_b)
    q, k, v = (t.reshape(N, L, nh, hd).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    scale = 1.0 / float(hd) ** 0.5
    sc = (q @ k.transpose(-1, -2)) * scale
    if lookback is not None:
        pos = torch.arange(L, device=x.device)
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] >= pos[:, None] - lookback)
        sc = sc.masked_fill(~band, float("-inf"))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    pn = rnd(p / (p.sum(dim=-1, keepdim=True) + 1e-20))
    ctx = rnd((pn @ v).transpose(1, 2).reshape(rows, C))
    a = ctx @ rnd(out_w) + out_b

    # ---- combine layer: LeakyReLU and Linear backward ----
    freq = lin_w.shape[0] == 2 * C
    if freq:
        comb = rnd(g) @ rnd(lin_w[:C]) + rnd(a) @ rnd(lin_w[C:]) + lin_b
    else:
        comb = rnd(a) @ rnd(lin_w) + lin_b
    dcomb = do * torch.where(comb >= 0, 1.0, 0.2)
    dlin_b = dcomb.sum(dim=0)
    dcr = rnd(dcomb)
    dga = dcr @ rnd(lin_w).t()                         # [rows, lin_in]
    if freq:
        dg_lin, da = dga[:, :C], dga[:, C:]
        dlin_w = torch.cat([rnd(g).t() @ dcr, rnd(a).t() @ dcr], dim=0)
    else:
        dg_lin, da = None, dga
        dlin_w = rnd(a).t() @ dcr

    # ---- out-proj and attention core backward ----
    dout_b = da.sum(dim=0)
    dar = rnd(da)
    dout_w = ctx.t() @ dar
    dctx = rnd(dar @ rnd(out_w).t())
    dch = dctx.reshape(N, L, nh, hd).transpose(1, 2)   # [N, nh, L, hd]
    dv = pn.transpose(-1, -2) @ dch
    dp = dch @ v.transpose(-1, -2)
    dsoft = rnd(pn * (dp - (dp * pn).sum(dim=-1, keepdim=True)))
    dq = (dsoft @ k) * scale
    dk = (dsoft.transpose(-1, -2) @ q) * scale
    dqkv = rnd(torch.cat([t.transpose(1, 2).reshape(rows, C)
                          for t in (dq, dk, dv)], dim=-1))
    din_b = dqkv.sum(dim=0)
    din_w = rnd(n2).t() @ dqkv
    dn2 = dqkv @ rnd(in_w).t()

    # ---- LN2 backward; the GRU output's cotangent ----
    dln2s = (dn2 * xh2).sum(dim=0)
    dln2b = dn2.sum(dim=0)
    ds = do + _ln_bwd(dn2, xh2, rs2, ln2s)
    dg = ds + dg_lin if freq else ds

    # ---- GRU recompute: n1, xp, shifted hiddens, hp ----
    n1, xh1, rs1 = _ln_fwd(xf, ln1s, ln1b)
    n1g = rnd(n1).reshape(N, L, G, H)
    dgg = dg.reshape(N, L, G, H)
    dn1 = torch.zeros((N, L, G, H), dtype=f32, device=x.device)
    zero = torch.zeros((N, 1, G, H), dtype=f32, device=x.device)
    dw_ih, dw_hh, db_ih, db_hh = [], [], [], []
    for d in range(D):
        xp = torch.einsum("nlgi,gio->nlgo", n1g, rnd(w_ih[d])) + b_ih[d]
        h = hid[d].reshape(N, L, G, H)
        if d == 0:   # forward direction: h_{t-1}, zero at t = 0
            hprev = torch.cat([zero, h[:, :L - 1]], dim=1)
        else:        # backward direction: h_{t+1}, zero at t = L - 1
            hprev = torch.cat([h[:, 1:], zero], dim=1)
        whh = rnd(w_hh[d])
        hp = torch.einsum("nlgi,gio->nlgo", rnd(hprev), whh) + b_hh[d]

        # Hoisted gate algebra: every per-step gradient is dh_t times a
        # per-t factor, so the loop below carries no transcendentals.
        r = torch.sigmoid(xp[..., :H] + hp[..., :H])
        z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(xp[..., 2 * H:] + r * hp[..., 2 * H:])
        pf = (1.0 - z) * (1.0 - n * n)
        k1 = pf * hp[..., 2 * H:] * r * (1.0 - r)
        k2 = (hprev - n) * z * (1.0 - z)
        k3 = pf * r

        # BPTT: the forward direction walks t descending, the backward
        # direction ascending.
        dh = torch.empty((N, L, G, H), dtype=f32, device=x.device)
        carry = torch.zeros((N, G, H), dtype=f32, device=x.device)
        steps = range(L) if d == 1 else range(L - 1, -1, -1)
        for t in steps:
            dht = carry + dgg[:, t]
            dh[:, t] = dht
            dhp_t = torch.cat([dht * k1[:, t], dht * k2[:, t],
                               dht * k3[:, t]], dim=-1)
            carry = dht * z[:, t] + torch.einsum("ngo,gjo->ngj",
                                                 rnd(dhp_t), whh)
        dxp = torch.cat([dh * k1, dh * k2, dh * pf], dim=-1)
        dhp = torch.cat([dh * k1, dh * k2, dh * k3], dim=-1)
        dw_ih.append(torch.einsum("nlgi,nlgo->gio", n1g, rnd(dxp)))
        dw_hh.append(torch.einsum("nlgi,nlgo->gio", rnd(hprev), rnd(dhp)))
        db_ih.append(dxp.sum(dim=(0, 1)))
        db_hh.append(dhp.sum(dim=(0, 1)))
        dn1 = dn1 + torch.einsum("nlgo,gio->nlgi", rnd(dxp), rnd(w_ih[d]))

    # ---- LN1 backward; dx ----
    dn1 = dn1.reshape(rows, C)
    dln1s = (dn1 * xh1).sum(dim=0)
    dln1b = dn1.sum(dim=0)
    dx = (ds + _ln_bwd(dn1, xh1, rs1, ln1s)).reshape(N, L, C)
    return (dx, dln1s, dln1b, torch.stack(dw_ih), torch.stack(dw_hh),
            torch.stack(db_ih), torch.stack(db_hh), dln2s, dln2b,
            din_w, din_b, dout_w, dout_b, dlin_w, dlin_b)


_P = ctypes.c_void_p
# lct_ftf_backward_bf16 and _f32 alike: 17 inputs, 15 gradients, the
# scratch; N; L, D, lin_in, lookback; the widths (the true C, num_heads,
# the score scale, slots); device; the stream.
_BWD_ARGTYPES = ([_P] * 33 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                 + BLOCK_WIDTHS + [ctypes.c_int, _P])


def _kernel_slots(C: int, groups: int, num_heads: int) -> int:
    """GRU slots the kernels run `groups` groups of the block's C channels
    in at its kernel width (the padded group count where that is not C)."""
    CK = padding.kernel_width(C, num_heads, groups)
    return CK // gru_slot(padding.padded_groups(C, groups, CK), CK)


def ftf_bwd_scratch_bytes(N: int, L: int, D: int, lin_in: int,
                          precise: bool, num_heads: int = 4,
                          groups: int = 4, C: int = 64) -> int:
    """Bytes of device scratch one `fused_ftf_bwd` launch of this shape
    takes in a mode, for a block of C channels (lin_in = 2C or C) in
    num_heads heads and `groups` GRU groups: f32 intermediates of every
    stage (precise), or the tensor-core design's bf16 intermediates and
    partial sums (bf16: the softmax statistics grow with the head count,
    the GRU weights' partial sums with the slot width, its partial rows
    follow the current card's grid sizes). Needs the card."""
    from lct_gan_tpu_torch.ops._build import kernel_function

    slots = _kernel_slots(C, groups, num_heads)
    CK = padding.kernel_width(C, num_heads, groups)
    if precise:
        fn = kernel_function("ftf_bwd", "lct_ftf_backward_scratch_floats",
                             [ctypes.c_longlong] + [ctypes.c_int] * 5, CK)
        fn.restype = ctypes.c_longlong
        nbytes = 4 * int(fn(N, L, D, C, num_heads, slots))
    else:
        fn = kernel_function("ftf_bwd", "lct_ftf_backward_bf16_scratch_bytes",
                             [ctypes.c_longlong] + [ctypes.c_int] * 6, CK)
        fn.restype = ctypes.c_longlong
        nbytes = int(fn(N, L, D, lin_in // C * CK, C, num_heads, slots))
    if nbytes < 0:
        raise RuntimeError("fused_ftf_bwd: no scratch size for these "
                           f"widths (num_heads={num_heads}, groups={groups}) "
                           "or the card's grid sizes could not be queried")
    return nbytes


_GRADS = Tuple[(torch.Tensor,) * 15]


def ftf_bwd_plain(x: torch.Tensor, ln1s: torch.Tensor, ln1b: torch.Tensor,
                   w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                   b_hh: torch.Tensor, ln2s: torch.Tensor, ln2b: torch.Tensor,
                   in_w: torch.Tensor, in_b: torch.Tensor, out_w: torch.Tensor,
                   out_b: torch.Tensor, lin_w: torch.Tensor,
                   lin_b: torch.Tensor, hid: torch.Tensor, dout: torch.Tensor,
                   bidirectional: bool, num_heads: int,
                   lookback: Optional[int], precise: bool) -> _GRADS:
    """The op on the CPU."""
    return ftf_bwd_reference(
        x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b, in_w, in_b, out_w,
        out_b, lin_w, lin_b, hid, dout, bidirectional=bidirectional,
        num_heads=num_heads, lookback=lookback, precise=precise)


def check_backward_shapes(name: str, x, w_ih, lin_w, num_heads: int,
                          bidirectional: bool) -> None:
    """Raise unless the FTF backward kernel takes these shapes: the
    forward's (`ops/ftf.py::check_kernel_shapes`) at any num_heads and GRU
    group count that divides C whose padded layout fits the backward's
    widest kernel width, 512 (`ops/library.py::check_kernel_widths` with
    `training`); widths it does not take are refused naming enc_channels,
    the width a user sets."""
    from lct_gan_tpu_torch.ops.ftf import check_kernel_shapes

    check_kernel_widths(f"{name} kernel", x.shape[-1], num_heads=num_heads,
                        groups=w_ih.shape[1], training=True,
                        hint=" (the bottleneck, enc_channels[-1])")
    check_kernel_shapes(name, x, w_ih, lin_w, num_heads, bidirectional)


def _ftf_bwd_fake(x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b, in_w,
                  in_b, out_w, out_b, lin_w, lin_b, hid, dout, bidirectional,
                  num_heads, lookback, precise):
    if x.device.type == "cuda":
        check_backward_shapes("fused_ftf_bwd", x, w_ih, lin_w, num_heads,
                              bidirectional)
    return tuple(t.new_empty(t.shape, dtype=torch.float32) for t in (
        x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b, in_w, in_b,
        out_w, out_b, lin_w, lin_b))


def true_gradients(grads, C: int, groups: int, num_heads: int):
    """The 15 gradients of the padded block (`ops/ftf.py::kernel_operands`'s
    operands, the GRU's already out of its slots) at the true block's
    channels: the inverse of each pad (`ops/padding.py::unpad_*`), or the
    gradients as they are where C needs no padding."""
    CK = padding.kernel_width(C, num_heads, groups)
    cidx = padding.channel_map(C, groups, CK)
    if cidx is None:
        return tuple(grads)
    hidx = padding.head_map(C, num_heads, CK)
    return (padding.unpad_last(grads[0], cidx),
            *padding.unpad_ln(*grads[1:3], cidx),
            *padding.unpad_gru(*grads[3:7], C, groups),
            *padding.unpad_ln(*grads[7:9], cidx),
            *padding.unpad_in_proj(*grads[9:11], cidx, hidx, CK),
            *padding.unpad_out_proj(*grads[11:13], hidx, cidx),
            *padding.unpad_lin(*grads[13:15], cidx, CK))


def _ftf_bwd_cuda(x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b, in_w,
                  in_b, out_w, out_b, lin_w, lin_b, hid, dout, bidirectional,
                  num_heads, lookback, precise):
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)
    from lct_gan_tpu_torch.ops.ftf import kernel_operands

    args = (x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b, in_w, in_b,
            out_w, out_b, lin_w, lin_b, hid, dout)
    check_backward_shapes("fused_ftf_bwd", x, w_ih, lin_w, num_heads,
                          bidirectional)
    N, L, C = x.shape
    D = 2 if bidirectional else 1
    G = w_ih.shape[1]
    H = C // G
    lin_in = lin_w.shape[0]
    dev = x.device
    shapes = ((N, L, C), (C,), (C,), (D, G, H, 3 * H), (D, G, H, 3 * H),
              (D, G, 3 * H), (D, G, 3 * H), (C,), (C,), (C, 3 * C),
              (3 * C,), (C, C), (C,), (lin_in, C), (C,), (D, N * L, C),
              (N, L, C))
    names = ("x", "ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih", "b_hh",
             "ln2_scale", "ln2_bias", "in_w", "in_b", "out_w", "out_b",
             "lin_w", "lin_b", "hid", "dout")
    ops = [f32_operand(n, t, s, dev) for n, t, s in zip(names, args, shapes)]
    CK = padding.kernel_width(C, num_heads, G)
    # The forward's operands at the kernels' width (padded where it is not
    # C), the GRU packed into slots; hid and dout padded as x is.
    kops, cidx = kernel_operands([*ops[:15], None], num_heads)
    kops = kops[:15] + [ops[15], ops[16]]
    if cidx is not None:
        kops[15:] = [padding.pad_last(t, cidx, CK) for t in ops[15:]]
    slots = kops[3].shape[1]
    grads = [torch.empty(t.shape, device=dev, dtype=torch.float32)
             for t in kops[:15]]
    with torch.cuda.device(dev):
        nbytes = ftf_bwd_scratch_bytes(N, L, D, lin_in, precise, num_heads,
                                       G, C)
    scratch = torch.empty((nbytes,), device=dev, dtype=torch.uint8)
    entry = "lct_ftf_backward_f32" if precise else "lct_ftf_backward_bf16"
    fn = kernel_function("ftf_bwd", entry, _BWD_ARGTYPES, CK)
    err = fn(*(t.data_ptr() for t in kops), *(t.data_ptr() for t in grads),
             scratch.data_ptr(), N, L, D, lin_in // C * CK,
             -1 if lookback is None else lookback, C, num_heads,
             padding.score_scale(C // num_heads), slots,
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "ftf_bwd", "fused_ftf_bwd kernel launch", CK)
    fused_ftf_bwd.launches += 1
    fused_ftf_bwd.design = kernel_design(precise)
    grads[3:7] = unpack_gru_slot_grads(*grads[3:7],
                                       padding.padded_groups(C, G, CK))
    return true_gradients(grads, C, G, num_heads)


# The operator -> the 15 gradients (no autograd of its own).
ftf_bwd_op = define_op("fused_ftf_bwd", ftf_bwd_plain, _ftf_bwd_cuda,
                       _ftf_bwd_fake)


def fused_ftf_bwd(x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b,
                  in_w, in_b, out_w, out_b, lin_w, lin_b, hid, dout, *,
                  bidirectional: bool, num_heads: int = 4,
                  lookback: Optional[int] = None,
                  precise: bool = False) -> Tuple[torch.Tensor, ...]:
    """FTF block backward: x, dout [N, L, C], hid [D, N*L, C] (the
    forward's unrounded per-direction hiddens), num_heads heads and G GRU
    groups (w_ih [D, G, C/G, 3*C/G]), each dividing C -> the 15 gradients
    of `ftf_bwd_reference`, all f32: the op
    `torch.ops.lct_gan_tpu_torch.fused_ftf_bwd`.

    CPU tensors: `ftf_bwd_reference(..., precise=precise)`. CUDA tensors:
    the kernels of csrc/ftf_bwd.cu (the widths the forward takes, else it
    raises before any launch), each launch counted in
    `fused_ftf_bwd.launches`, the design recorded in `fused_ftf_bwd.design`.
    Deterministic: parameter gradients are summed over fixed row chunks,
    then over the chunks in a fixed order."""
    return ftf_bwd_op(x, ln1s, ln1b, w_ih, w_hh, b_ih, b_hh, ln2s, ln2b,
                      in_w, in_b, out_w, out_b, lin_w, lin_b, hid, dout,
                      bool(bidirectional), int(num_heads),
                      None if lookback is None else int(lookback),
                      bool(precise))


fused_ftf_bwd.launches = 0
fused_ftf_bwd.design = None   # kernel design of the last launch

"""Plain PyTorch grouped GRU (port of `lct_gan_tpu/ops/gru.py:28`).

G independent GRUs of hidden size H over the channel groups of x [N, L,
G*H], with torch.nn.GRU gate math (gate order r, z, n; the reset gate
multiplies the projected hidden state):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) n + z h

Params are stacked [D, G, H, 3H] / [D, G, 3H] (D = 2 when bidirectional);
the two directions' outputs are summed. This is the plain version inside
the FTF block's reference (ops/ftf.py).

`fused_grouped_gru` is LN1 and the grouped GRU of the composed time block
above L = 512 (models/generator.py), where the fused block's attention
stops: the counterpart of the lax.scan that the JAX package runs outside
any Pallas kernel. It is the `torch.library` operator
`lct_gan_tpu_torch::fused_grouped_gru` (`gru_op`, `ops/library.py`). On a
CUDA tensor it launches one all-f32 kernel of `csrc/ftf.cu`
(`lct_grouped_gru_f32`, `gru_f32_kernel`: LN1, the input projection and
the recurrence in one pass, producer warps staging x and xp in shared
memory a chunk ahead of the consumer warps' steps; design `GRU_DESIGN`);
on a CPU tensor it computes `grouped_gru_plain`; groups of 256 units
(kernel widths 256 and 512) take LN1's input projection into an xp scratch
and the thread-block-cluster recurrence (`gru_cluster_kernel`) instead, and
one group of 512 (kernel width 512) the same scratch and a launch a step
over all sequences (`gru_step_kernel`). Its backward differentiates the
plain version.

The CUDA kernels take C channels in any number of groups that divides C,
where the groups' padded layout fits the widest kernel
(`ops/library.py::card_takes`). The FTF kernels run
slots of 16 units, or dense ones of C (of 64 at C = 128, of 64 or 128 at
C = 256, of 64, 128 or 256 at C = 512; `gru_slot`), and
`pack_gru_slots` packs other group counts into them
(`unpack_gru_slot_grads` takes the FTF backward's slot-layout gradients
apart again); `fused_grouped_gru`'s kernel takes the groups as they are
(slots of each group's width, or of 16 holding narrower groups, built in
the kernel). Where C is not a power of two from 16 the wrapper first
widens each group to a power of two with zero channels and units
(`ops/padding.py`; exact), so the kernels run at the GRU's own kernel
width (`ops/padding.py::kernel_width(C, groups=G)`, 16 .. 512).
"""

from __future__ import annotations

import ctypes

import torch

from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.library import check_kernel_widths, define_op

__all__ = ["grouped_gru", "grouped_gru_hidden", "round_bf16", "layer_norm",
           "grouped_gru_plain", "fused_grouped_gru", "gru_op", "gru_slot",
           "pack_gru_slots", "unpack_gru_slot_grads", "gru_kernel_operands",
           "gru_xp_shape", "GRU_DESIGN"]

# The design `fused_grouped_gru` runs on the card: warp-specialised, all
# f32 on CUDA cores, one launch (csrc/ftf.cu, gru_f32_kernel).
GRU_DESIGN = "ws-f32"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax LayerNorm math (fast-variance form) over the last axis."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 precision (nearest-even), kept in f32: a
    GEMM operand of the bf16 kernels, whose products are exact in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def grouped_gru_hidden(x: torch.Tensor, w_ih: torch.Tensor,
                       w_hh: torch.Tensor, b_ih: torch.Tensor,
                       b_hh: torch.Tensor, *, bidirectional: bool,
                       precise: bool = True) -> torch.Tensor:
    """Per-direction hidden states of the grouped GRU: x [N, L, G*H] ->
    [D, N, L, G*H] f32 (D = 2 when bidirectional), unrounded.

    precise=False rounds the GEMM operands (x and W_ih; h and W_hh) to bf16
    as the FTF kernel does; accumulation, carries and gates stay f32."""
    N, L, C = x.shape
    D, G, H, _ = w_ih.shape
    if C != G * H:
        raise ValueError(f"Expected {G * H} channels, got {C}")
    rnd = (lambda t: t) if precise else round_bf16
    xg = rnd(x.to(torch.float32)).reshape(N, L, G, H)
    D = D if bidirectional else 1
    hid = []
    for d in range(D):
        # Hoisted input projection over all steps: [N, L, G, 3H].
        xp = torch.einsum("nlgi,gio->nlgo", xg, rnd(w_ih[d])) + b_ih[d]
        whh = rnd(w_hh[d])
        h = x.new_zeros((N, G, H), dtype=torch.float32)
        steps = [None] * L
        for t in (range(L - 1, -1, -1) if d == 1 else range(L)):
            hp = torch.einsum("ngh,gho->ngo", rnd(h), whh) + b_hh[d]
            xt = xp[:, t]
            r = torch.sigmoid(xt[..., :H] + hp[..., :H])
            z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
            n = torch.tanh(xt[..., 2 * H:] + r * hp[..., 2 * H:])
            h = (1.0 - z) * n + z * h
            steps[t] = h
        # Stacked once, not written step by step into a buffer: no in-place
        # write, so the loop traces into a functional graph (a portable
        # export decomposes the kernel ops into this plain version).
        hid.append(torch.stack(steps, dim=1))
    return torch.stack(hid).reshape(D, N, L, C)


def grouped_gru(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                b_ih: torch.Tensor, b_hh: torch.Tensor, *,
                bidirectional: bool, precise: bool = True) -> torch.Tensor:
    """x [N, L, G*H] -> [N, L, G*H] f32: the directions' hiddens summed.

    Differentiable by autograd (the composed time block trains through it).
    precise=False rounds the GEMM operands as `grouped_gru_hidden` says."""
    return grouped_gru_hidden(x, w_ih, w_hh, b_ih, b_hh,
                              bidirectional=bidirectional,
                              precise=precise).sum(dim=0)


def grouped_gru_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w_ih: torch.Tensor,
                      w_hh: torch.Tensor, b_ih: torch.Tensor,
                      b_hh: torch.Tensor, bidirectional: bool) -> torch.Tensor:
    """The op on the CPU, and its decomposition in a portable export: LN1
    (eps 1e-6), then the all-f32 grouped GRU, x [N, L, G*H] -> [N, L, G*H]."""
    return grouped_gru(layer_norm(x, ln_scale, ln_bias), w_ih, w_hh, b_ih,
                       b_hh, bidirectional=bidirectional, precise=True)


def _check_gru_shapes(x: torch.Tensor, w_ih: torch.Tensor) -> None:
    """Raise unless the kernels take these shapes: C channels in G groups
    of C / G (G dividing C) whose padded layout fits the widest kernel,
    w_ih [D, G, C / G, 3 * C / G]."""
    C = x.shape[-1]
    G = w_ih.shape[1]
    check_kernel_widths("fused_grouped_gru kernel", C, groups=G)
    if tuple(w_ih.shape[1:]) != (G, C // G, 3 * (C // G)):
        raise ValueError(f"fused_grouped_gru kernel takes w_ih [D, {G}, "
                         f"{C // G}, {3 * (C // G)}], got "
                         f"{tuple(w_ih.shape)}")


def gru_slot(groups: int, C: int = 64) -> int:
    """The width of the slots the GRU kernels run `groups` groups of C
    channels in (C a power of two, the kernels' width): 16 units for
    groups of 16 or fewer, else one dense slot of C, or at C >= 128 slots
    of 64 for groups of 64 or fewer (the tensor-core recurrence's register
    budget), at C >= 256 slots of 128 for groups of 128, at C = 512 slots
    of 256 for groups of 256 (a slot of 256 is the thread-block-cluster
    kernel's, one of 512 the step kernel's)."""
    width = C // groups
    if width <= 16:
        return 16
    if C > 64 and width <= 64:
        return 64
    if C > 128 and width <= 128:
        return 128
    return 256 if C > 256 and width <= 256 else C


def pack_gru_slots(w_ih, w_hh, b_ih, b_hh):
    """G groups' GRU weights [D, G, H, 3H] / [D, G, 3H] (C = G H a power of
    two) packed into the kernels' slots of W = gru_slot(G, C) units: [D,
    C / W, W, 3W] / [D, C / W, 3W], the groups of a slot on its block
    diagonal (the TPU kernel's packing, lct_gan_tpu/ops/ftf.py:331).
    Exact: the entries off the blocks are 0 and add nothing. Returned as
    they are where the groups are slots already (groups of 16, or 1)."""
    D, G, H, _ = w_ih.shape
    W = gru_slot(G, G * H)
    if H == W:
        return w_ih, w_hh, b_ih, b_hh
    k, S = W // H, G * H // W          # groups a slot, slots
    eye = torch.eye(k, dtype=w_ih.dtype, device=w_ih.device)

    def mat(w):   # [D, S, k, H in, gate, H unit] -> [D, S, k*H, gate, k*H]
        return (w.reshape(D, S, k, H, 3, 1, H)
                * eye.view(1, 1, k, 1, 1, k, 1)).reshape(D, S, W, 3 * W)

    def vec(b):   # [D, S, k, gate, H] -> [D, S, gate, k*H]
        return b.reshape(D, S, k, 3, H).transpose(2, 3).reshape(D, S, 3 * W)

    return mat(w_ih), mat(w_hh), vec(b_ih), vec(b_hh)


def unpack_gru_slot_grads(dw_ih, dw_hh, db_ih, db_hh, groups: int):
    """The inverse of `pack_gru_slots` for gradients: slot-layout weight
    gradients [D, C / W, W, 3W] / bias gradients [D, C / W, 3W] (W =
    gru_slot(groups, C)) back to the grouped [D, G, H, 3H] / [D, G, 3H]. A
    weight gradient keeps each group's diagonal block of its slot; the
    entries off the blocks belong to no parameter (the packed weight is 0
    there) and are dropped. A bias gradient leaves the gate-major order of
    its slot. Returned as they are where the groups are slots already."""
    D, S, W, _ = dw_ih.shape
    H = S * W // groups
    if H == W:
        return dw_ih, dw_hh, db_ih, db_hh
    k = W // H                          # groups a slot

    def mat(w):   # [D, S, k in, H in, gate, k out, H unit] -> diagonal
        w = w.reshape(D, S, k, H, 3, k, H).diagonal(dim1=2, dim2=5)
        return w.permute(0, 1, 5, 2, 3, 4).reshape(D, groups, H, 3 * H)

    def vec(b):   # [D, S, gate, k, H] -> [D, S, k, gate, H]
        return b.reshape(D, S, 3, k, H).transpose(2, 3).reshape(
            D, groups, 3 * H)

    return mat(dw_ih), mat(dw_hh), vec(db_ih), vec(db_hh)


def gru_kernel_operands(ops):
    """The composed GRU kernel's operands from (x, ln_scale, ln_bias, w_ih,
    w_hh, b_ih, b_hh): padded to the GRU's own kernel width (groups only:
    the attention after it takes its own) with zero channels and units
    (`ops/padding.py`), the groups a power of two wide, where that width is
    not C; elsewhere as they are. Returns (operands, idx): idx [C] the
    output channels that are x's (None: all)."""
    C, G = ops[0].shape[-1], ops[3].shape[1]
    CK = padding.kernel_width(C, groups=G)
    idx = padding.channel_map(C, G, CK)
    ops = list(ops)
    if idx is not None:
        ops = [padding.pad_last(ops[0], idx, CK),
               *padding.pad_ln(*ops[1:3], idx, CK),
               *padding.pad_gru(*ops[3:], C, CK)]
    return ops, idx


def _gru_fake(x, ln_scale, ln_bias, w_ih, w_hh, b_ih, b_hh, bidirectional):
    if x.device.type == "cuda":
        _check_gru_shapes(x, w_ih)
    return x.new_empty(x.shape, dtype=torch.float32)


_P = ctypes.c_void_p
# lct_grouped_gru_f32: 7 inputs (the GRU's grouped), hid, xp (null but for
# groups of 256 or 512, gru_xp_shape); N; L, D, groups, the true C, device;
# stream.
_GRU_ARGTYPES = [_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [_P]


def gru_xp_shape(rows: int, D: int, CK: int, groups: int):
    """The composed GRU kernel's xp scratch, [rows, D 3CK] f32: LN1's input
    projection, which the recurrence of groups of 256 or 512 units reads
    (the cluster kernel at kernel widths 256 and 512, the step kernel at
    512); None elsewhere (one launch, xp in shared memory). At kernel width
    512 that is 6 KB a row and direction: 6.7 GB at the frequency block's
    main shape (544,896 rows, two directions)."""
    return (rows, D * 3 * CK) if CK // groups > 128 else None


def _gru_cuda(x, ln_scale, ln_bias, w_ih, w_hh, b_ih, b_hh, bidirectional):
    from lct_gan_tpu_torch.ops._build import (f32_operand, kernel_function,
                                              raise_on_error)

    _check_gru_shapes(x, w_ih)
    N, L, C = x.shape
    D = 2 if bidirectional else 1
    G = w_ih.shape[1]
    H = C // G
    dev = x.device
    f = f32_operand
    ops = [f("x", x, (N, L, C), dev), f("ln_scale", ln_scale, (C,), dev),
           f("ln_bias", ln_bias, (C,), dev),
           f("w_ih", w_ih, (D, G, H, 3 * H), dev),
           f("w_hh", w_hh, (D, G, H, 3 * H), dev),
           f("b_ih", b_ih, (D, G, 3 * H), dev),
           f("b_hh", b_hh, (D, G, 3 * H), dev)]
    ops, idx = gru_kernel_operands(ops)
    CK = ops[0].shape[-1]
    hid = torch.empty((D, N * L, CK), device=dev, dtype=torch.float32)
    xp_shape = gru_xp_shape(N * L, D, CK, ops[3].shape[1])
    xp = (None if xp_shape is None
          else torch.empty(xp_shape, device=dev, dtype=torch.float32))
    fn = kernel_function("ftf", "lct_grouped_gru_f32", _GRU_ARGTYPES, CK)
    err = fn(*(t.data_ptr() for t in ops), hid.data_ptr(),
             None if xp is None else xp.data_ptr(),
             N, L, D, ops[3].shape[1], C,
             dev.index if dev.index is not None else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(err, "ftf", "fused_grouped_gru kernel launch", CK)
    fused_grouped_gru.launches += 1
    out = hid[0] if D == 1 else hid[0] + hid[1]
    if idx is not None:
        out = out.index_select(-1, idx.to(dev))
    return out.view(N, L, C)


def _gru_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7])
    ctx.bidirectional = inputs[7]


def _gru_backward(ctx, dout):
    """The plain version's gradients, recomputed under autograd (the
    composed block trains as the plain loop does)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        out = grouped_gru_plain(*inputs, ctx.bidirectional)
        grads = torch.autograd.grad(out, inputs, dout)
    return (*grads, None)


gru_op = define_op("fused_grouped_gru", grouped_gru_plain, _gru_cuda,
                   _gru_fake)
torch.library.register_autograd(gru_op, _gru_backward,
                                setup_context=_gru_setup_context)


def fused_grouped_gru(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w_ih: torch.Tensor,
                      w_hh: torch.Tensor, b_ih: torch.Tensor,
                      b_hh: torch.Tensor, *,
                      bidirectional: bool) -> torch.Tensor:
    """LN1 and the grouped GRU over x [N, L, C] -> [N, L, C] f32, any L:
    the op `torch.ops.lct_gan_tpu_torch.fused_grouped_gru`.

    CPU tensors: `grouped_gru_plain`. CUDA tensors: one launch of the f32
    kernel of csrc/ftf.cu (any C in any group count dividing C whose
    padded layout fits the widest kernel, else it raises;
    `check_kernel_widths`), counted in
    `fused_grouped_gru.launches`, from an exported program too.
    Differentiable in x and the six parameters (the plain version's
    gradients, recomputed)."""
    return gru_op(x, ln_scale, ln_bias, w_ih, w_hh, b_ih, b_hh,
                  bool(bidirectional))


fused_grouped_gru.launches = 0

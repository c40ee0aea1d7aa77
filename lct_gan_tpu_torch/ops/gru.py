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
the FTF block's reference (ops/ftf.py) and, on the card, the composed path
of the time block above L = 512 -- the counterpart of the lax.scan that the
JAX package runs outside any Pallas kernel.
"""

from __future__ import annotations

import torch

__all__ = ["grouped_gru", "grouped_gru_hidden", "round_bf16"]


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

"""Grouped GRU module (`lct_gan_tpu/models/gru.py:38-123`).

The reference runs G independent torch.nn.GRU modules of hidden size H,
one per channel group, named gru1..gruG directly under the FTF block
(`gen.GRUt1.gru1.weight_ih_l0`, ...). `GRUGroup` holds one group's
parameters under those names (torch layout: weight_ih_l0 [3H, H], gate order
r, z, n; `_reverse` for the backward direction); `stack_groups` turns a
block's groups into the stacked [D, G, H, 3H] / [D, G, 3H] arrays that the
kernels and `ops.gru` take.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

__all__ = ["GRUGroup", "stack_groups"]


class GRUGroup(nn.Module):
    """Parameters of one single-layer torch.nn.GRU(H, H) (no forward: the
    recurrence runs in the FTF kernel or in ops.gru.fused_grouped_gru)."""

    def __init__(self, hidden_size: int, bidirectional: bool):
        super().__init__()
        H = hidden_size
        bound = 1.0 / H ** 0.5  # torch.nn.GRU's default init
        for sfx in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih_l0", (3 * H, H)),
                                ("weight_hh_l0", (3 * H, H)),
                                ("bias_ih_l0", (3 * H,)),
                                ("bias_hh_l0", (3 * H,))):
                self.register_parameter(name + sfx, nn.Parameter(
                    torch.empty(shape).uniform_(-bound, bound)))
        self.directions = 2 if bidirectional else 1


def stack_groups(groups: Sequence[GRUGroup]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(w_ih, w_hh [D, G, H, 3H], b_ih, b_hh [D, G, 3H]) of a block."""
    D = groups[0].directions
    out = []
    for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
        per_dir = []
        for d in range(D):
            sfx = "_reverse" if d == 1 else ""
            ts = [getattr(grp, name + sfx) for grp in groups]
            if name.startswith("weight"):
                ts = [t.t() for t in ts]
            per_dir.append(torch.stack(ts))
        out.append(torch.stack(per_dir).contiguous())
    return tuple(out)

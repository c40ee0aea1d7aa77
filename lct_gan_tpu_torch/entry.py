"""Driver entry points (the counterpart of `__graft_entry__.py`).

    entry(device="cuda", params=None, precise=False) -> (fn, (wave,))
        the enhancer forward at TrainConfig() widths; fn(noisy [B, T]) ->
        enhanced [B, T] on the device; wave = zeros((8, 32000)), a batch of
        2 s at 16 kHz.
    dryrun_multichip(n, device="cuda")
        one GAN train step over n data-parallel ranks against the 1-rank
        step (parallel/dryrun.py); raises if a check fails.

    python -m lct_gan_tpu_torch.entry [n] [--device D]
        the CLI of parallel/dryrun.py (n defaults to 2)

The JAX package re-executes itself with n forced CPU devices; here each
rank is a process of its own (`parallel.spawn`), so nothing is forced.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda", params: Optional[Mapping[str, Any]] = None,
          precise: bool = False
          ) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor]]:
    """(fn, (wave,)): the enhancer at TrainConfig() widths on `device` (the
    card unless "cpu" is asked; raises without a GPU) and its example input.

    Weights: `params`, a JAX-package generator param tree (nested dicts of
    arrays), loaded with strict=True; else seeded as `create_state` seeds
    the enhancer, from torch.Generator().manual_seed(0) (flax's PRNGKey(0)
    init has no torch counterpart). precise=True runs the FTF kernels'
    products in f32."""
    from lct_gan_tpu_torch.eval.serve import make_enhance
    from lct_gan_tpu_torch.train.state import TrainConfig, seeded_models
    from lct_gan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    enhancer, _, _ = seeded_models(TrainConfig(),
                                   torch.Generator().manual_seed(0),
                                   precise=precise, g_params=params)
    fn = make_enhance(enhancer.to(dev))
    wave = torch.zeros((8, 32000), dtype=torch.float32, device=dev)
    return fn, (wave,)


def dryrun_multichip(n: int, device="cuda") -> dict:
    """One GAN step over n ranks against the 1-rank step
    (`parallel.dryrun.dryrun`); raises when a check fails, else returns
    its report."""
    from lct_gan_tpu_torch.parallel.dryrun import dryrun

    return dryrun(n, device)


if __name__ == "__main__":
    # All of the work stays under this guard: the ranks that
    # parallel.spawn starts re-import the main module.
    from lct_gan_tpu_torch.parallel.dryrun import main

    main()

"""Training configuration and GAN train state (`lct_gan_tpu/train/
state.py:28-167`).

Two AdamW optimizers as the reference sets them up: G over the enhancer's
parameters, D over MPD + MSD jointly, betas (0.8, 0.99), eps 1e-8, weight
decay 0.01 on every parameter (optax's default mask), and a global-norm
clip on G only, with optax's rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from lct_gan_tpu_torch.convert.weights import (jax_disc_params_to_state_dict,
                                               jax_params_to_state_dict)
from lct_gan_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                     MultiScaleDiscriminator)
from lct_gan_tpu_torch.models.generator import LCTGeneratorConfig, LctEnhancer
from lct_gan_tpu_torch.utils.device import resolve_device

__all__ = ["TrainConfig", "GanTrainState", "build_models", "make_optimizers",
           "clip_by_global_norm", "create_state", "state_from_jax_params"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig: the same fields and defaults."""

    sample_rate: int = 16000
    segment_seconds: float = 2.0
    batch_size: int = 8
    epochs: int = 100
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    betas_g: Tuple[float, float] = (0.8, 0.99)
    betas_d: Tuple[float, float] = (0.8, 0.99)
    grad_clip: float = 5.0
    lambda_mask: float = 1.0
    lambda_adv: float = 1e-2
    lambda_fm: float = 1.0
    gan_loss: str = "ls"
    compress_c: float = 0.3
    num_heads: int = 4
    gru_groups: int = 4
    max_time_context: Optional[int] = None
    # Spectral norm on MPD and MSD scale 0; every training forward runs one
    # power iteration (torch's semantics).
    use_spectral_norm: bool = False
    # Real and fake concat-batched through each stack under spectral norm
    # too: one power iteration per stack and step phase instead of one per
    # forward (same fixed point, another u/v trajectory).
    fast_spectral_norm: bool = False
    # bf16 discriminator compute (parameters stay f32).
    bf16: bool = False
    seed: int = 42
    log_interval: int = 50
    val_interval: int = 50
    ckpt_interval: int = 50
    val_target_batch_seconds: float = 256.0

    @property
    def segment_length(self) -> int:
        return int(self.segment_seconds * self.sample_rate)


@dataclasses.dataclass
class GanTrainState:
    """Both players and their optimizers. The spectral-norm u/v buffers
    live inside the discriminators; `step` counts optimisation steps."""

    enhancer: LctEnhancer
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0

    def g_params(self) -> List[torch.nn.Parameter]:
        return list(self.enhancer.parameters())

    def d_params(self) -> List[torch.nn.Parameter]:
        return [*self.mpd.parameters(), *self.msd.parameters()]


def build_models(cfg: TrainConfig, *, precise: bool = False,
                 generator: Optional[torch.Generator] = None):
    """(enhancer, mpd, msd) on the CPU. num_heads, gru_groups and
    max_time_context are honoured. The discriminators' convs draw from
    `generator` (flax's fan-in uniform, g = ||v||, zero bias); the
    enhancer keeps its modules' own init. precise=True runs the FTF kernels'
    products in f32."""
    gen_cfg = LCTGeneratorConfig(num_heads=cfg.num_heads,
                                 gru_groups=cfg.gru_groups,
                                 max_time_context=cfg.max_time_context)
    ddtype = torch.bfloat16 if cfg.bf16 else torch.float32
    enhancer = LctEnhancer(gen_cfg=gen_cfg, c=cfg.compress_c, precise=precise)
    mpd = MultiPeriodDiscriminator(use_spectral_norm=cfg.use_spectral_norm,
                                   dtype=ddtype, generator=generator)
    msd = MultiScaleDiscriminator(use_spectral_norm=cfg.use_spectral_norm,
                                  dtype=ddtype, generator=generator)
    return enhancer, mpd, msd


def make_optimizers(cfg: TrainConfig, g_params: Sequence[torch.Tensor],
                    d_params: Sequence[torch.Tensor]):
    """(g_opt, d_opt): AdamW, eps 1e-8, weight decay 0.01. The G clip is
    applied to the gradients before g_opt.step (`clip_by_global_norm`)."""
    g_opt = torch.optim.AdamW(g_params, lr=cfg.lr_g, betas=cfg.betas_g,
                              eps=1e-8, weight_decay=0.01)
    d_opt = torch.optim.AdamW(d_params, lr=cfg.lr_d, betas=cfg.betas_d,
                              eps=1e-8, weight_decay=0.01)
    return g_opt, d_opt


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: leave the gradients as they are when
    their global norm is below max_norm, else scale each by max_norm / norm
    (as g / norm * max_norm). torch's clip_grad_norm_ divides by
    norm + 1e-6 instead."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm)
            for g in grads]


def _assemble(cfg, enhancer, mpd, msd, device):
    dev = resolve_device(device)
    enhancer, mpd, msd = enhancer.to(dev), mpd.to(dev), msd.to(dev)
    d_params = [*mpd.parameters(), *msd.parameters()]
    g_opt, d_opt = make_optimizers(cfg, list(enhancer.parameters()), d_params)
    return GanTrainState(enhancer, mpd, msd, g_opt, d_opt)


def create_state(cfg: TrainConfig,
                 generator: Optional[torch.Generator] = None, *,
                 device="cuda", precise: bool = False,
                 g_params: Optional[Mapping[str, Any]] = None
                 ) -> GanTrainState:
    """A fresh train state on `device` (the card unless "cpu" is asked).

    `generator` seeds every draw (default: a generator seeded with
    cfg.seed). g_params: optional JAX-package generator param tree (nested
    dicts of arrays, e.g. from `read_npz_params`) to start G from."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    g_seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(g_seed)
        enhancer, mpd, msd = build_models(cfg, precise=precise,
                                          generator=generator)
    if g_params is not None:
        enhancer.load_state_dict(jax_params_to_state_dict(g_params),
                                 strict=True)
    return _assemble(cfg, enhancer, mpd, msd, device)


def state_from_jax_params(cfg: TrainConfig, g_params: Mapping[str, Any],
                          mpd_params: Mapping[str, Any],
                          msd_params: Mapping[str, Any],
                          spectral: Optional[Mapping[str, Any]] = None, *,
                          device="cuda", precise: bool = False
                          ) -> GanTrainState:
    """A train state from JAX-package param trees (numpy arrays) through
    the weight bridge: the generator's `jax_params_to_state_dict`, the
    discriminators' `jax_disc_params_to_state_dict` (spectral: the state's
    {"mpd": ..., "msd": ...} u/v tree). Fresh optimizer states."""
    enhancer, mpd, msd = build_models(cfg, precise=precise)
    enhancer.load_state_dict(jax_params_to_state_dict(g_params), strict=True)
    mpd_sd, msd_sd = jax_disc_params_to_state_dict(mpd_params, msd_params,
                                                   spectral)
    mpd.load_state_dict(mpd_sd, strict=True)
    msd.load_state_dict(msd_sd, strict=True)
    return _assemble(cfg, enhancer, mpd, msd, device)

"""Train LCT-GAN (LctEnhancer + MPD/MSD) with the PyTorch port on one GPU.

    python -m lct_gan_tpu_torch.train_cli --data_root D [--expr_root E]
        [--epochs N] [--batch_size B] [--resume E/<ts>/ckpts/last.pt]
        [--device cpu] ...

The flags are the JAX package's `train.py` (the reference train.py's, plus
--no_pesq / --no_stoi, spectral-norm and bf16 options), and --device. The
run directory E/<timestamp>/ holds ckpts/{last,best,epoch_%04d}.pt,
configs.json and metrics.csv; `python -m lct_gan_tpu_torch.infer
--checkpoint E/<ts>/ckpts/best.pt` serves the result.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train LCT-GAN (LctEnhancer + MPD/MSD), PyTorch port")

    # Experiment management
    parser.add_argument("--expr_root", type=str, default="exprs")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume from "
                             "(e.g. exprs/<ts>/ckpts/last.pt)")

    # Data
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--train_scp", type=str, default="train.scp")
    parser.add_argument("--test_scp", type=str, default="test.scp")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--segment_seconds", type=float, default=2.0)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="Host decode threads + prefetch depth "
                             "(reference train.py:118 num_workers).")

    # Optimization
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr_g", type=float, default=2e-4)
    parser.add_argument("--lr_d", type=float, default=2e-4)
    parser.add_argument("--betas_g", type=float, nargs=2, default=(0.8, 0.99))
    parser.add_argument("--betas_d", type=float, nargs=2, default=(0.8, 0.99))
    parser.add_argument("--grad_clip", type=float, default=5.0)

    # Loss weights
    parser.add_argument("--lambda_mask", type=float, default=1.0)
    parser.add_argument("--lambda_adv", type=float, default=1e-2)
    parser.add_argument("--lambda_fm", type=float, default=1.0)
    parser.add_argument("--gan_loss", type=str, default="ls",
                        choices=["ls", "hinge"])

    # Model / STFT
    parser.add_argument("--compress_c", type=float, default=0.3)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--gru_groups", type=int, default=4)
    parser.add_argument("--max_time_context", type=int, default=None,
                        help="Banded-causal time-attention lookback in "
                             "frames (None = full attention, matching the "
                             "reference's trained behavior).")
    parser.add_argument("--use_spectral_norm", action="store_true",
                        help="Spectral norm on MPD + MSD scale 0 (the "
                             "reference supports this at module level, "
                             "discriminators.py:243-248, but never exposed "
                             "a flag).")
    parser.add_argument("--fast_spectral_norm", action="store_true",
                        help="With --use_spectral_norm: concat-batch the "
                             "real+fake discriminator applies (the fast "
                             "weight-norm schedule). Same per-sample math; "
                             "the u/v power-iteration trajectory differs "
                             "from torch's sequential order but converges "
                             "to the same steady state "
                             "(tools/sn_dynamics.py).")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 discriminator compute (f32 params and "
                             "optimizer state).")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log_interval", type=int, default=50)

    # Validation / checkpointing cadence
    parser.add_argument("--val_interval", type=int, default=50)
    parser.add_argument("--ckpt_interval", type=int, default=50)
    parser.add_argument("--val_target_batch_seconds", type=float,
                        default=256.0,
                        help="Padded audio-seconds per adaptive "
                             "validation batch (big B for short length "
                             "buckets -> device utilization; metrics are "
                             "per-utterance and unchanged). 0 = fixed "
                             "batch_size validation batches.")
    parser.add_argument("--no_pesq", action="store_true",
                        help="Skip PESQ during validation (package gated).")
    parser.add_argument("--no_stoi", action="store_true")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="Capture a torch.profiler trace of steps 3 "
                             "to 3 + this many of the first epoch into "
                             "<run_dir>/profile/trace.json.")

    # Parallelism and device
    parser.add_argument("--data_parallel", type=int, default=None,
                        help="Data-parallel size. Only 1 (one device) is "
                             "ported so far.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel not in (None, 1):
        sys.exit(f"--data_parallel {args.data_parallel}: data parallelism is "
                 "not ported yet (ROADMAP.md Queue 1 item 5); run with one "
                 "device")
    random.seed(args.seed)
    np.random.seed(args.seed)

    from lct_gan_tpu_torch.train import DataConfig, TrainConfig, run_training

    cfg = TrainConfig(
        sample_rate=args.sample_rate,
        segment_seconds=args.segment_seconds,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr_g=args.lr_g,
        lr_d=args.lr_d,
        betas_g=tuple(args.betas_g),
        betas_d=tuple(args.betas_d),
        grad_clip=args.grad_clip,
        lambda_mask=args.lambda_mask,
        lambda_adv=args.lambda_adv,
        lambda_fm=args.lambda_fm,
        gan_loss=args.gan_loss,
        compress_c=args.compress_c,
        num_heads=args.num_heads,
        gru_groups=args.gru_groups,
        max_time_context=args.max_time_context,
        use_spectral_norm=args.use_spectral_norm,
        fast_spectral_norm=args.fast_spectral_norm,
        bf16=args.bf16,
        seed=args.seed,
        log_interval=args.log_interval,
        val_interval=args.val_interval,
        ckpt_interval=args.ckpt_interval,
        val_target_batch_seconds=args.val_target_batch_seconds,
    )
    data = DataConfig(
        data_root=args.data_root,
        train_scp=args.train_scp,
        test_scp=args.test_scp,
        num_prefetch=max(2, args.num_workers),
        num_workers=args.num_workers,
    )
    return run_training(cfg, data, expr_root=args.expr_root,
                        resume=args.resume, device=args.device,
                        compute_pesq=not args.no_pesq,
                        compute_stoi=not args.no_stoi,
                        profile_steps=args.profile_steps)


if __name__ == "__main__":
    main()

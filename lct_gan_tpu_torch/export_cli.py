"""Export a trained enhancer to a self-contained serialized artifact (the
JAX package's `export.py` contract, with the port's `export_model`).

    python -m lct_gan_tpu_torch.export_cli --checkpoint C \
        --output enhancer.lct.zip [--batch_size 8] [--seconds 2 4] \
        [--adaptive_buckets MIN_S MAX_S [--target_batch_seconds 256]] \
        [--compress_c c] [--max_time_context W] [--keep_kernels] \
        [--device cpu]

The checkpoint is a generator `.npz` or a reference-format `.pt`; its saved
compress_c and max_time_context apply unless overridden (with a warning
when an override differs). A portable artifact (the default) holds ATen ops
only and is traced on the CPU whatever --device says; --keep_kernels
traces on --device and keeps the CUDA kernel ops. Load side:

    from lct_gan_tpu_torch.export_model import load_exported
    enhance = load_exported("enhancer.lct.zip", device="cuda")
    out = enhance(noisy_batch)   # numpy [B, T] float32 in and out
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export the enhancer (PyTorch port)")
    p.add_argument("--checkpoint", required=True,
                   help="generator .npz or reference-format .pt")
    p.add_argument("--output", required=True, help="output .zip path")
    p.add_argument("--batch_size", type=int, default=None,
                   help="Rows per exported shape (default 8). With "
                        "--adaptive_buckets this is the row CAP "
                        "(default 128).")
    p.add_argument("--seconds", type=float, nargs="+", default=[2.0, 4.0],
                   help="utterance-length buckets to export")
    p.add_argument("--adaptive_buckets", type=float, nargs=2, default=None,
                   metavar=("MIN_S", "MAX_S"),
                   help="Instead of --seconds x batch_size, export one "
                        "shape per geometric length bucket covering "
                        "[MIN_S, MAX_S] seconds with length-ADAPTIVE row "
                        "counts (target_batch_seconds padded audio per "
                        "batch), the serving-side mirror of the infer "
                        "CLI's adaptive batching.")
    p.add_argument("--target_batch_seconds", type=float, default=256.0,
                   help="Padded audio-seconds per adaptive shape "
                        "(--adaptive_buckets only).")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--compress_c", type=float, default=None)
    p.add_argument("--max_time_context", type=int, default=None)
    p.add_argument("--keep_kernels", action="store_true",
                   help="keep the CUDA kernel ops in the programs (loading "
                        "needs this package and a card)")
    p.add_argument("--device", default="cuda",
                   help="where the weights load and a --keep_kernels "
                        "program is traced (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.export_model import (adaptive_export_shapes,
                                                export_enhancer)

    enhancer = load_enhancer(args.checkpoint, device=args.device,
                             compress_c=args.compress_c,
                             max_time_context=args.max_time_context)
    if args.adaptive_buckets is not None:
        lo, hi = args.adaptive_buckets
        shapes = adaptive_export_shapes(
            lo, hi, args.sample_rate,
            target_batch_seconds=args.target_batch_seconds,
            max_batch=128 if args.batch_size is None else args.batch_size)
    else:
        b = 8 if args.batch_size is None else args.batch_size
        shapes = [(b, int(s * args.sample_rate)) for s in args.seconds]
    export_enhancer(args.output, enhancer, shapes,
                    keep_kernels=args.keep_kernels,
                    sample_rate=args.sample_rate)
    print(f"Exported {len(shapes)} shape(s) {shapes} to {args.output}")


if __name__ == "__main__":
    main()

"""Batched wav-in/wav-out enhancement with the port (the JAX package's
`infer.py` contract).

    python -m lct_gan_tpu_torch.infer --data_root D --checkpoint C \
        --output_dir O [--exact_lengths] [--pad_outputs]

Reads D/noisy_test/<id>.wav for every id of D/<test_scp>, enhances them
in length-sorted, length-adaptive bucketed batches with per-row `lengths`
(or one utterance at a time at its exact length with --exact_lengths), and
writes O/<id>.wav trimmed to its true length (--pad_outputs keeps the
padded length, as the reference's infer.py does). The checkpoint is a
generator `.npz` or a reference-format `.pt`; its saved compress_c and
max_time_context apply unless overridden.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LCT-GAN inference (PyTorch port)")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--test_scp", type=str, default="test.scp")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="generator .npz or reference-format .pt")
    p.add_argument("--output_dir", type=str, default="enhanced_test")
    p.add_argument("--batch_size", type=int, default=128,
                   help="row cap of an adaptive bucketed batch")
    p.add_argument("--target_batch_seconds", type=float, default=256.0,
                   help="padded audio-seconds per adaptive batch")
    p.add_argument("--compress_c", type=float, default=None)
    p.add_argument("--max_time_context", type=int, default=None)
    p.add_argument("--exact_lengths", action="store_true",
                   help="one utterance per batch at its exact length")
    p.add_argument("--pad_outputs", action="store_true",
                   help="save padded-length wavs (the reference's quirk)")
    p.add_argument("--chunk_seconds", type=float, default=None,
                   help="chunked streaming enhancement (not ported yet)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.chunk_seconds is not None:
        sys.exit("--chunk_seconds (chunked streaming) is not ported to the "
                 "PyTorch package yet; run without it, or use the JAX "
                 "package's infer.py")

    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import (bucketed_batches, load_mono_wave,
                                        read_scp, write_wav)
    from lct_gan_tpu_torch.eval import make_enhance

    enhancer = load_enhancer(args.checkpoint, device=args.device,
                             compress_c=args.compress_c,
                             max_time_context=args.max_time_context)
    enhance = make_enhance(enhancer)

    scp = args.test_scp
    if not os.path.isabs(scp):
        scp = os.path.join(args.data_root, scp)
    ids = read_scp(scp)
    noisy_dir = os.path.join(args.data_root, "noisy_test")
    waves = {uid: load_mono_wave(os.path.join(noisy_dir, f"{uid}.wav"),
                                 args.sample_rate)[0] for uid in ids}
    os.makedirs(args.output_dir, exist_ok=True)

    target = (None if args.exact_lengths
              else int(args.target_batch_seconds * args.sample_rate))
    t0 = time.time()
    total_audio, n_done = 0.0, 0
    for batch in bucketed_batches(ids, waves, args.batch_size, target):
        # Exact shapes need no key masking: lengths=None keeps the run
        # identical to enhancing the utterance alone.
        lengths = None if args.exact_lengths else batch["lengths"]
        enhanced = enhance(batch["noisy"], lengths).cpu().numpy()
        for i, uid in enumerate(batch["id"]):
            L = int(batch["lengths"][i])
            wave = enhanced[i] if args.pad_outputs else enhanced[i, :L]
            write_wav(os.path.join(args.output_dir, f"{uid}.wav"), wave,
                      args.sample_rate)
            total_audio += L / args.sample_rate
            n_done += 1
        print(f"[{n_done}/{len(ids)}] enhanced", flush=True)
    dt = time.time() - t0
    print(f"Done: {n_done} utterances, {total_audio:.1f}s audio in "
          f"{dt:.1f}s ({total_audio / max(dt, 1e-9):.2f}x realtime)")


if __name__ == "__main__":
    main()

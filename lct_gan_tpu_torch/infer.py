"""Batched wav-in/wav-out enhancement with the port (the JAX package's
`infer.py` contract).

    python -m lct_gan_tpu_torch.infer --data_root D --checkpoint C \
        --output_dir O [--exact_lengths] [--pad_outputs] \
        [--max_time_context W] [--chunk_seconds S [--chunk_overlap V]]

Reads D/noisy_test/<id>.wav for every id of D/<test_scp>, enhances them
in length-sorted, length-adaptive bucketed batches with per-row `lengths`
(or one utterance at a time at its exact length with --exact_lengths), and
writes O/<id>.wav trimmed to its true length (--pad_outputs keeps the
padded length, as the reference's infer.py does). --max_time_context W
serves banded-causal time attention (each frame sees the W frames before
it). --chunk_seconds enhances one utterance at a time in overlapping
chunks crossfaded over --chunk_overlap seconds (eval/streaming.py), written
at its true length. The checkpoint is a generator `.npz` or a
reference-format `.pt`; its saved compress_c and max_time_context apply
unless overridden.
"""

from __future__ import annotations

import argparse
import os
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
                   help="enhance in fixed-size overlapping chunks (bounded "
                        "memory and batch shapes; for long recordings)")
    p.add_argument("--chunk_overlap", type=float, default=0.5,
                   help="crossfade seconds between chunks (at most half a "
                        "chunk)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import (bucketed_batches, load_mono_wave,
                                        read_scp, write_wav)
    from lct_gan_tpu_torch.eval import enhance_in_chunks, make_enhance

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

    if args.chunk_seconds is not None:
        def enhance_np(batch):
            return enhance(batch).cpu().numpy()

        t0 = time.time()
        total_audio = 0.0
        for n_done, uid in enumerate(ids, 1):
            out = enhance_in_chunks(
                enhance_np, waves[uid], args.sample_rate,
                chunk_seconds=args.chunk_seconds,
                overlap_seconds=args.chunk_overlap)
            write_wav(os.path.join(args.output_dir, f"{uid}.wav"), out,
                      args.sample_rate)
            total_audio += out.shape[-1] / args.sample_rate
            print(f"[{n_done}/{len(ids)}] enhanced (chunked)", flush=True)
        _done(len(ids), total_audio, time.time() - t0)
        return

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
    _done(n_done, total_audio, time.time() - t0)


def _done(n_done: int, total_audio: float, dt: float) -> None:
    print(f"Done: {n_done} utterances, {total_audio:.1f}s audio in "
          f"{dt:.1f}s ({total_audio / max(dt, 1e-9):.2f}x realtime)")


if __name__ == "__main__":
    main()

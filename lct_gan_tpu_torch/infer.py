"""Batched wav-in/wav-out enhancement with the port (the JAX package's
`infer.py` contract).

    python -m lct_gan_tpu_torch.infer --data_root D --checkpoint C \
        --output_dir O [--exact_lengths] [--no_sort_by_length] \
        [--pad_outputs] [--num_workers N] [--max_time_context W] \
        [--chunk_seconds S [--chunk_overlap V]]

Streams D/noisy_test/<id>.wav for every id of D/<test_scp> through
`ScpDataset` (noisy side only), `batch_iterator` and a background
`Prefetcher` that decodes and copies the next batches while the current one
runs: by default in length-sorted, length-adaptive bucketed batches with
per-row `lengths`; in scp order with a fixed batch size under
--no_sort_by_length; one utterance at a time at its exact length with
--exact_lengths. Writes O/<id>.wav trimmed to its true length
(--pad_outputs keeps the padded length, as the reference's infer.py does).
--max_time_context W serves banded-causal time attention (each frame sees
the W frames before it). --chunk_seconds enhances one utterance at a time
in overlapping chunks crossfaded over --chunk_overlap seconds
(eval/streaming.py), written at its true length. The checkpoint is a
generator `.npz` or a `.pt` (the reference's format, as the port's trainer
writes it); its saved compress_c and max_time_context apply unless
overridden.
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
    p.add_argument("--batch_size", type=int, default=None,
                   help="row cap of an adaptive bucketed batch (default "
                        "128); with --no_sort_by_length the fixed batch "
                        "size (default 32)")
    p.add_argument("--target_batch_seconds", type=float, default=256.0,
                   help="padded audio-seconds per adaptive batch")
    p.add_argument("--no_sort_by_length", action="store_true",
                   help="scp order in fixed batches instead of "
                        "length-sorted adaptive bucketing")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host decode threads (and prefetch depth)")
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
    from lct_gan_tpu_torch.data import (Prefetcher, ScpDataset,
                                        batch_iterator, write_wav)
    from lct_gan_tpu_torch.eval import enhance_in_chunks, make_enhance

    enhancer = load_enhancer(args.checkpoint, device=args.device,
                             compress_c=args.compress_c,
                             max_time_context=args.max_time_context)
    enhance = make_enhance(enhancer)
    device = next(enhancer.parameters()).device

    # Inference needs only the noisy side: the clean wavs are not decoded.
    ds = ScpDataset(args.data_root, args.test_scp, "test",
                    sample_rate=args.sample_rate, segment_length=None,
                    random_segment=False, load_clean=False)
    os.makedirs(args.output_dir, exist_ok=True)
    depth = max(2, args.num_workers)

    if args.chunk_seconds is not None:
        def enhance_np(batch):
            return enhance(batch).cpu().numpy()

        t0 = time.time()
        total_audio, n_done = 0.0, 0
        # Decode on a background thread, overlapping the device's chunks.
        decoded = Prefetcher(
            ((uid, ds[i]) for i, uid in enumerate(ds.utt_ids)), depth=depth)
        for n_done, (uid, sample) in enumerate(decoded, 1):
            out = enhance_in_chunks(
                enhance_np, sample["noisy"], args.sample_rate,
                chunk_seconds=args.chunk_seconds,
                overlap_seconds=args.chunk_overlap)
            write_wav(os.path.join(args.output_dir, f"{uid}.wav"), out,
                      args.sample_rate)
            total_audio += out.shape[-1] / args.sample_rate
            print(f"[{n_done}/{len(ds)}] enhanced (chunked)", flush=True)
        _done(n_done, total_audio, time.time() - t0)
        return

    sort_by_length = not args.exact_lengths and not args.no_sort_by_length
    if args.exact_lengths:
        batch_size = 1
    elif args.batch_size is not None:
        batch_size = args.batch_size
    else:
        batch_size = 128 if sort_by_length else 32
    adaptive = (int(args.target_batch_seconds * args.sample_rate)
                if sort_by_length else None)
    it = Prefetcher(
        batch_iterator(ds, batch_size, bucket=not args.exact_lengths,
                       sort_by_length=sort_by_length,
                       adaptive_target_samples=adaptive,
                       num_workers=args.num_workers),
        depth=depth, device=device, array_keys=("noisy",))
    t0 = time.time()
    total_audio, n_done = 0.0, 0
    for batch in it:
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
        print(f"[{n_done}/{len(ds)}] enhanced", flush=True)
    _done(n_done, total_audio, time.time() - t0)


def _done(n_done: int, total_audio: float, dt: float) -> None:
    print(f"Done: {n_done} utterances, {total_audio:.1f}s audio in "
          f"{dt:.1f}s ({total_audio / max(dt, 1e-9):.2f}x realtime)")


if __name__ == "__main__":
    main()

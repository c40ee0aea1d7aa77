"""Serving latency on the card: B = 1 per-call latency and real-time factor
(the port of the JAX package's `tools/bench_serving_latency.py`).

    python -m lct_gan_tpu_torch.bench_serving_latency \
        [--max_time_context 64] [--utterance_seconds 2 10] \
        [--chunk_seconds 1 2 4] [--overlap_seconds 0.5]

  * one-shot: B = 1, one whole utterance per call (the interactive
    "enhance this recording" case).
  * streaming: B = 1, one chunk per call at `eval/streaming.py`'s chunk
    geometry. A new chunk arrives every hop = chunk - overlap seconds, so
    real time needs compute < hop: the streaming RTF is hop / compute. A
    sample at a seam is final once the chunk that holds it has been
    captured and enhanced: its latency is chunk + compute. Chunk / overlap
    pairs that `enhance_in_chunks` refuses (overlap > chunk / 2) are
    refused before any timing.

Per call: `device_ms`, CUDA events around `--iters` back-to-back calls
divided by the count (median of `--repeats`); `wall_ms`, the host clock
around one call that ends in `torch.cuda.synchronize()` (median of
`--repeats`). RTFs and latencies use `wall_ms`, what a caller waits for.
Weights and inputs are random from fixed seeds: the work does not depend
on them. Prints one
JSON line on stdout, the card's nvidia-smi name and power limit with it;
writes no file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

SR = 16000


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def one_shot_rtf(seconds: float, compute_ms: float) -> float:
    """Audio seconds enhanced per second of compute."""
    return seconds / (compute_ms / 1e3)


def streaming_rtf(chunk_seconds: float, overlap_seconds: float,
                  compute_ms: float) -> float:
    """New audio per chunk (the hop) over the chunk's compute: > 1 keeps
    up with a live stream."""
    return (chunk_seconds - overlap_seconds) / (compute_ms / 1e3)


def seam_latency_ms(chunk_seconds: float, compute_ms: float) -> float:
    """Worst-case latency of a sample: the whole chunk holding it is
    captured, then enhanced."""
    return chunk_seconds * 1e3 + compute_ms


def time_call(torch, enhance, x, iters: int, repeats: int):
    """(median device ms per call over `iters` back-to-back calls, median
    wall ms of one synchronized call), each over `repeats`."""
    enhance(x)                                   # warm-up
    torch.cuda.synchronize()
    device, wall = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            enhance(x)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / iters)
        t0 = time.perf_counter()
        enhance(x)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(device), statistics.median(wall)


def measure(enhance, utterance_seconds, chunk_seconds, overlap_seconds,
            iters: int = 20, repeats: int = 5):
    """The rows of the benchmark for `enhance` ([1, T] tensor on the card ->
    [1, T] tensor on the card)."""
    import torch

    from lct_gan_tpu_torch.eval.streaming import chunk_geometry

    for ch in chunk_seconds:                     # refuse before any timing
        chunk_geometry(ch, overlap_seconds, SR)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for secs in utterance_seconds:
        x = 0.1 * torch.randn((1, int(secs * SR)), generator=g,
                              device="cuda")
        dev, wall = time_call(torch, enhance, x, iters, repeats)
        rows.append({"mode": "one-shot", "seconds": secs, "device_ms": dev,
                     "wall_ms": wall, "rtf": one_shot_rtf(secs, wall)})
        log(f"one-shot B=1 {secs:.1f} s: device {dev:.2f} ms, wall "
            f"{wall:.2f} ms (RTF {rows[-1]['rtf']:.0f}x)")
    for ch in chunk_seconds:
        x = 0.1 * torch.randn((1, int(ch * SR)), generator=g, device="cuda")
        dev, wall = time_call(torch, enhance, x, iters, repeats)
        rows.append({"mode": "streaming-chunk", "seconds": ch,
                     "overlap_seconds": overlap_seconds, "device_ms": dev,
                     "wall_ms": wall,
                     "rtf": streaming_rtf(ch, overlap_seconds, wall),
                     "seam_latency_ms": seam_latency_ms(ch, wall)})
        log(f"chunk B=1 {ch:.1f} s (overlap {overlap_seconds} s): wall "
            f"{wall:.2f} ms, RTF {rows[-1]['rtf']:.0f}x, seam latency "
            f"{rows[-1]['seam_latency_ms']:.0f} ms")
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="B=1 serving latency on the "
                                             "card (PyTorch port)")
    ap.add_argument("--max_time_context", type=int, default=None,
                    help="banded-causal lookback (frames); the causal "
                         "serving configuration for streaming")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--utterance_seconds", type=float, nargs="*",
                    default=[2.0, 10.0])
    ap.add_argument("--chunk_seconds", type=float, nargs="*",
                    default=[1.0, 2.0, 4.0])
    ap.add_argument("--overlap_seconds", type=float, default=0.5)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                resolve_device)

    dev = resolve_device("cuda")
    card = gpu_name_and_power_limit()
    log(f"device: {card}")
    torch.manual_seed(0)
    enhancer = LctEnhancer(LCTGeneratorConfig(
        max_time_context=args.max_time_context)).to(dev)
    rows = measure(make_enhance(enhancer), args.utterance_seconds,
                   args.chunk_seconds, args.overlap_seconds, args.iters,
                   args.repeats)
    print(json.dumps({"device": card,
                      "max_time_context": args.max_time_context,
                      "rows": rows}))


if __name__ == "__main__":
    main()

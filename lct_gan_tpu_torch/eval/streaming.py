"""Chunked (streaming) enhancement for long or unbounded audio
(`lct_gan_tpu/eval/streaming.py`).

Audio is processed in fixed-size overlapping chunks whose seams are
crossfaded with raised-cosine ramps:

  * a bounded set of batch shapes whatever the input length (chunk batches
    are padded to power-of-two row counts, at most log2(max_batch)+1
    shapes);
  * bounded memory: arbitrarily long files stream through;
  * the crossfade hides boundary artifacts from the STFT edge padding and
    the bidirectional frequency GRUs.

With a causal configuration (`max_time_context` banded attention and the
already-causal time GRU) this is the serving path for true streaming with
chunk-level latency.

`enhance_in_chunks` and `_crossfade_ramp` are copies of the JAX package's
numpy-only functions (their chunk check is `chunk_geometry`, which the
serving-latency tool shares); `StreamingEnhancer` is built on the port's
`load_enhancer` + `make_enhance`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lct_gan_tpu_torch.convert import load_enhancer
from lct_gan_tpu_torch.eval.serve import make_enhance

__all__ = ["StreamingEnhancer", "enhance_in_chunks", "chunk_geometry"]


def _crossfade_ramp(n: int) -> np.ndarray:
    """Raised-cosine fade-in of length n (fade-out is its mirror)."""
    return (0.5 - 0.5 * np.cos(np.pi * (np.arange(n) + 0.5) / n)).astype(
        np.float32)


def chunk_geometry(chunk_seconds: float, overlap_seconds: float,
                   sample_rate: int = 16000):
    """(chunk, overlap) in samples; raises ValueError unless the overlap is
    at most half the chunk."""
    C = int(chunk_seconds * sample_rate)
    V = int(overlap_seconds * sample_rate)
    if V > C // 2:
        # With hop = C - V < C/2, three or more chunks would overlap each
        # sample and the fade-in/fade-out pair no longer sums to 1
        # (amplitude ripple).
        raise ValueError(
            f"overlap ({V} samples) must be at most half the chunk "
            f"({C} samples)")
    return C, V


def enhance_in_chunks(enhance_fn,
                      wave: np.ndarray,
                      sample_rate: int = 16000,
                      chunk_seconds: float = 4.0,
                      overlap_seconds: float = 0.5,
                      max_batch: int = 32) -> np.ndarray:
    """Enhance a 1D waveform in overlapping chunks.

    Args:
      enhance_fn: callable [B, C] numpy -> [B, C] array (fixed chunk
        length C).
      wave: [T] float32.
      chunk_seconds / overlap_seconds: chunking geometry.
      max_batch: cap on chunks processed per call.

    Returns:
      enhanced [T] float32.
    """
    wave = np.asarray(wave, dtype=np.float32).reshape(-1)
    T = wave.shape[-1]
    C, V = chunk_geometry(chunk_seconds, overlap_seconds, sample_rate)
    hop = C - V
    if T <= C:
        n_chunks = 1
        padded = np.pad(wave, (0, C - T))
        chunks = padded[None]
    else:
        n_chunks = 1 + int(np.ceil((T - C) / hop))
        padded = np.pad(wave, (0, (n_chunks - 1) * hop + C - T))
        chunks = np.stack([padded[i * hop:i * hop + C]
                           for i in range(n_chunks)])

    def _row_bucket(n: int) -> int:
        # Bound the batch shapes: pad rows to the next power of two up to
        # max_batch -- at most log2(max_batch)+1 distinct shapes total.
        b = 1
        while b < min(n, max_batch):
            b *= 2
        return min(b, max_batch)

    outs = []
    for i in range(0, n_chunks, max_batch):
        batch = chunks[i:i + max_batch]
        rows = batch.shape[0]
        bucket = _row_bucket(rows)
        if rows < bucket:
            batch = np.concatenate(
                [batch, np.zeros((bucket - rows, C), np.float32)])
        outs.append(np.asarray(enhance_fn(batch))[:rows])
    enhanced_chunks = np.concatenate(outs, axis=0)
    if n_chunks == 1:
        return enhanced_chunks[0, :T]

    out = np.zeros_like(padded)
    ramp = _crossfade_ramp(V)
    for i in range(n_chunks):
        seg = enhanced_chunks[i].copy()
        if i > 0:
            seg[:V] *= ramp
        if i < n_chunks - 1:
            seg[C - V:] *= ramp[::-1]
        out[i * hop:i * hop + C] += seg
    return out[:T]


class StreamingEnhancer:
    """Checkpoint-backed chunked enhancer.

    compress_c / max_time_context default to the checkpoint's saved values
    (`load_enhancer`); the committed demo weights save 0.3 and None, the
    JAX class's defaults. Runs on the card unless device="cpu".

    Example:
        se = StreamingEnhancer("artifacts/train_demo/g_params_best.npz",
                               max_time_context=64)
        enhanced = se(wave_16k)
    """

    def __init__(self,
                 checkpoint: str,
                 sample_rate: int = 16000,
                 chunk_seconds: float = 4.0,
                 overlap_seconds: float = 0.5,
                 compress_c: Optional[float] = None,
                 max_time_context: Optional[int] = None,
                 max_batch: int = 32,
                 device="cuda",
                 precise: bool = False):
        self.sample_rate = sample_rate
        self.chunk_seconds = chunk_seconds
        self.overlap_seconds = overlap_seconds
        self.max_batch = max_batch
        enhance = make_enhance(load_enhancer(
            checkpoint, device=device, compress_c=compress_c,
            max_time_context=max_time_context, precise=precise))
        self.enhance_fn = lambda batch: enhance(batch).cpu().numpy()

    def __call__(self, wave: np.ndarray) -> np.ndarray:
        return enhance_in_chunks(
            self.enhance_fn, wave, self.sample_rate, self.chunk_seconds,
            self.overlap_seconds, self.max_batch)

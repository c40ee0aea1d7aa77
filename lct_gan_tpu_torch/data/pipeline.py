"""Length bucketing for bucketed inference (copies of
`lct_gan_tpu/data/pipeline.py:34-93`), plus a plain batch iterator over an
scp list for the port's infer CLI."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["bucket_length", "adaptive_slices", "bucketed_batches"]


def bucket_length(n: int, min_bucket: int = 16384) -> int:
    """Smallest padded length >= n from a {1, 1.25, 1.5, 1.75} x 2^k grid:
    O(log T) distinct shapes, at most 25% padding."""
    if n <= min_bucket:
        return min_bucket
    b = min_bucket
    while b < n:
        b *= 2
    half = b // 2
    for num in (5, 6, 7):  # half * 1.25 / 1.5 / 1.75
        cand = half * num // 4
        if cand >= n:
            return cand
    return b


def adaptive_slices(sorted_lens: Sequence[int], target_samples: int,
                    max_batch: int):
    """Length-adaptive batch slices over LENGTH-SORTED utterances: each
    batch's row count is clamp(target_samples // bucket, 1, max_batch) for
    its bucket, so the padded batch size stays about constant. A batch never
    spans buckets. Returns (start, end) pairs covering every index once, in
    order."""
    n = len(sorted_lens)
    slices = []
    i = 0
    while i < n:
        b = bucket_length(int(sorted_lens[i]))
        size = max(1, min(int(max_batch), target_samples // b))
        j = i + 1
        while (j < min(i + size, n)
               and bucket_length(int(sorted_lens[j])) == b):
            j += 1
        slices.append((i, j))
        i = j
    return slices


def bucketed_batches(ids: List[str], waves: Dict[str, np.ndarray],
                     max_batch: int,
                     target_samples: Optional[int] = None
                     ) -> Iterator[Dict]:
    """Yield {'id', 'noisy' [B, T_bucket] f32, 'lengths' [B] int64}.

    target_samples given: length-sorted adaptive batches padded to their
    bucket (the JAX infer CLI's default). None: batches of one utterance at
    its exact length (its --exact_lengths mode)."""
    if target_samples is None:
        for uid in ids:
            w = waves[uid]
            yield {"id": [uid], "noisy": w[None].astype(np.float32),
                   "lengths": np.asarray([w.shape[-1]], np.int64)}
        return
    order = sorted(ids, key=lambda u: waves[u].shape[-1])
    lens = [waves[u].shape[-1] for u in order]
    for i, j in adaptive_slices(lens, target_samples, max_batch):
        chunk = order[i:j]
        pad_to = bucket_length(max(lens[i:j]))
        x = np.zeros((len(chunk), pad_to), np.float32)
        for r, uid in enumerate(chunk):
            x[r, :lens[i + r]] = waves[uid]
        yield {"id": chunk, "noisy": x,
               "lengths": np.asarray(lens[i:j], np.int64)}

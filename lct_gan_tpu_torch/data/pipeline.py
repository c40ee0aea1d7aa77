"""Host-side batching and prefetching (copies of
`lct_gan_tpu/data/pipeline.py:34-255`, with the device placement done by
PyTorch).

  * training batches have a fixed shape (segment_length samples);
  * validation and inference batches pad to geometric length buckets with
    explicit `lengths`, length-sorted and sized per bucket;
  * a background thread decodes the next batches and copies them to the
    device while the current step runs.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from lct_gan_tpu_torch.data.dataset import ScpDataset, collate

__all__ = ["batch_iterator", "Prefetcher", "bucket_length",
           "adaptive_slices"]


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


def batch_iterator(
    dataset: ScpDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    pad_to_segment: bool = False,
    bucket: bool = False,
    sort_by_length: bool = False,
    adaptive_target_samples: Optional[int] = None,
    seed: int = 0,
    epoch: int = 0,
    num_workers: int = 0,
    lookahead: int = 2,
) -> Iterator[Dict]:
    """Yield collated numpy batches from a ScpDataset.

    shuffle: order keyed on (seed, epoch), so a resumed run sees the order
      of an uninterrupted one.
    pad_to_segment: pad every batch to dataset.segment_length (fixed-shape
      training batches).
    bucket: pad full utterances to geometric length buckets (val / infer).
    sort_by_length: order utterances by their header-probed length (stable
      sort) so each bucketed batch is near-uniform in length. Ignored under
      shuffle.
    adaptive_target_samples: with bucket + sort_by_length, size each batch
      by its length bucket (adaptive_slices) with `batch_size` as the row
      cap.
    num_workers: > 0 decodes samples on a thread pool, `lookahead` batches
      of decode futures ahead of the consumer; 0 decodes in the caller. The
      batches are the same either way.
    """
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)  # resume-stable segment crops
    order = np.arange(len(dataset))
    sorted_lens = None
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    elif sort_by_length and hasattr(dataset, "num_samples"):
        lens = np.asarray([dataset.num_samples(int(i)) for i in order])
        sort = np.argsort(lens, kind="stable")
        order = order[sort]
        sorted_lens = lens[sort]
    n = len(order)
    end = n - (n % batch_size) if drop_last else n

    def _collate(samples):
        pad_to: Optional[int] = None
        if pad_to_segment and dataset.segment_length is not None:
            pad_to = dataset.segment_length
        elif bucket:
            mx = max(
                max(s["noisy"].shape[-1],
                    s["clean"].shape[-1] if "clean" in s else 0)
                for s in samples)
            pad_to = bucket_length(mx)
        return collate(samples, pad_to=pad_to)

    if adaptive_target_samples and bucket and sorted_lens is not None:
        if drop_last:
            raise ValueError(
                "drop_last is undefined with adaptive_target_samples "
                "(adaptive batches have no fixed size to drop against)")
        slices = adaptive_slices(sorted_lens, int(adaptive_target_samples),
                                 batch_size)
    else:
        slices = [(i, min(i + batch_size, end))
                  for i in range(0, end, batch_size)]
    if num_workers and num_workers > 0:
        ex = ThreadPoolExecutor(max_workers=int(num_workers),
                                thread_name_prefix="lct-decode")
        try:
            pending: deque = deque()
            it = iter(slices)
            exhausted = False
            while True:
                while not exhausted and len(pending) < max(1, lookahead):
                    try:
                        i, j = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append([ex.submit(dataset.__getitem__, int(k))
                                    for k in order[i:j]])
                if not pending:
                    break
                yield _collate([f.result() for f in pending.popleft()])
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
    else:
        for i, j in slices:
            yield _collate([dataset[int(k)] for k in order[i:j]])


class Prefetcher:
    """Background-thread prefetcher with optional device placement.

    Wraps any iterator of {str: np.ndarray} batches and runs it ahead of
    the consumer, `depth` batches deep. With a `device`, the `array_keys`
    arrays become tensors there (pinned host memory, then a non-blocking
    copy); without one, batches pass through as they are. An error in the
    wrapped iterator is raised on the consumer's side.

    The copy is made from the worker thread on the device's default
    stream, the stream the consumer's kernels run on, so a step never reads
    a batch before its copy has finished.
    """

    _SENTINEL = object()

    def __init__(self,
                 it: Iterator[Dict],
                 depth: int = 2,
                 device=None,
                 array_keys: Sequence[str] = ("noisy", "clean")):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        self._array_keys = array_keys
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(it,), daemon=True)
        self._thread.start()

    def _worker(self, it):
        try:
            if self._device is not None and self._device.type == "cuda":
                # Pin this thread to the default stream: the consumer's
                # kernels are ordered after the copy.
                with torch.cuda.stream(
                        torch.cuda.default_stream(self._device)):
                    for batch in it:
                        self._q.put(self._place(batch))
            else:
                for batch in it:
                    self._q.put(self._place(batch))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def _place(self, batch: Dict) -> Dict:
        if self._device is None:
            return batch
        out = dict(batch)
        for k in self._array_keys:
            if k in out:
                t = torch.from_numpy(np.ascontiguousarray(out[k]))
                if self._device.type == "cuda":
                    t = t.pin_memory().to(self._device, non_blocking=True)
                out[k] = t
        return out

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

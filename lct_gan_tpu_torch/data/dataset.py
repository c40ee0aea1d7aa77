"""scp-driven paired clean/noisy dataset (a copy of
`lct_gan_tpu/data/dataset.py:36-185`).

Layout: data_root/{clean,noisy}_{train,test}/<id>.wav plus one-ID-per-line
.scp files (blank lines and '#' comments skipped). Samples are mono,
optionally resampled, and optionally cropped to a shared-start segment
(random for training, centred otherwise); signals shorter than the segment
pass through and are zero-padded at collate time.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from lct_gan_tpu_torch.data.audio_io import (load_mono_wave, read_scp,
                                             wav_num_samples)

__all__ = ["read_scp", "ScpDataset", "collate"]


class ScpDataset:
    """Map-style paired dataset (the reference's LCTScpDataset)."""

    def __init__(
        self,
        data_root: str,
        scp_path: str,
        subset: str,
        *,
        sample_rate: Optional[int] = 16000,
        segment_length: Optional[int] = None,
        random_segment: bool = True,
        transform: Optional[Callable[[Dict], Dict]] = None,
        clean_subdir: Optional[str] = None,
        noisy_subdir: Optional[str] = None,
        seed: int = 0,
        load_clean: bool = True,
    ) -> None:
        """load_clean=False skips decoding the clean wav (samples carry no
        'clean' key): inference needs only the noisy side."""
        self.data_root = data_root
        self.sample_rate = sample_rate
        self.segment_length = segment_length
        self.random_segment = random_segment
        self.transform = transform
        # Crops are keyed on (seed, epoch, index), not drawn from a stateful
        # generator, so a resumed run draws the segments of an uninterrupted
        # one. batch_iterator calls set_epoch() each epoch.
        self.seed = seed
        self.epoch = 0
        self.load_clean = bool(load_clean)

        if not os.path.isabs(scp_path):
            scp_path = os.path.join(data_root, scp_path)
        self.scp_path = scp_path

        assert subset is not None
        self.subset = subset
        self.noisy_dir = os.path.join(data_root,
                                      noisy_subdir or f"noisy_{subset}")
        self.clean_dir = os.path.join(data_root,
                                      clean_subdir or f"clean_{subset}")

        self.utt_ids = read_scp(self.scp_path)
        if len(self.utt_ids) == 0:
            raise RuntimeError(f"No IDs found in scp file: {self.scp_path}")

    def __len__(self) -> int:
        return len(self.utt_ids)

    def set_epoch(self, epoch: int) -> None:
        """Advance the deterministic crop key (resume-stable data order)."""
        self.epoch = int(epoch)

    def num_samples(self, index: int, side: str = "noisy") -> int:
        """Post-resample length of the noisy (or clean) wave, from its
        header alone."""
        folder = {"noisy": self.noisy_dir, "clean": self.clean_dir}[side]
        path = os.path.join(folder, f"{self.utt_ids[index]}.wav")
        n, _ = wav_num_samples(path, self.sample_rate)
        return n

    def _crop_pair(self, noisy: np.ndarray, clean: np.ndarray, index: int):
        """Shared-start crop."""
        if self.segment_length is None:
            return noisy, clean
        seg = self.segment_length
        min_len = min(noisy.shape[-1], clean.shape[-1])
        if min_len <= seg:
            return noisy, clean
        max_start = min_len - seg
        if self.random_segment:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, index]))
            start = int(rng.integers(0, max_start + 1))
        else:
            start = max_start // 2
        return noisy[start:start + seg], clean[start:start + seg]

    def __getitem__(self, index: int) -> Dict:
        utt_id = self.utt_ids[index]
        noisy_path = os.path.join(self.noisy_dir, f"{utt_id}.wav")
        noisy, sr_noisy = load_mono_wave(noisy_path, self.sample_rate)
        if not self.load_clean:
            noisy, _ = self._crop_pair(noisy, noisy, index)
            sample: Dict = {"id": utt_id, "noisy": noisy, "sr": sr_noisy}
            if self.transform is not None:
                sample = self.transform(sample)
            return sample
        clean_path = os.path.join(self.clean_dir, f"{utt_id}.wav")
        clean, sr_clean = load_mono_wave(clean_path, self.sample_rate)
        if sr_noisy != sr_clean:
            raise RuntimeError(
                f"Sample rate mismatch for {utt_id}: noisy={sr_noisy}, "
                f"clean={sr_clean}")
        noisy, clean = self._crop_pair(noisy, clean, index)
        sample = {"id": utt_id, "noisy": noisy, "clean": clean,
                  "sr": sr_noisy}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


def collate(batch: List[Dict], pad_to: Optional[int] = None) -> Dict:
    """Zero-pad waves to the batch max (or `pad_to`, for bucketed padding)
    and stack; `lengths` holds each row's true noisy length."""
    if len(batch) == 0:
        return {}
    has_clean = "clean" in batch[0]
    ids = [b["id"] for b in batch]
    lengths = np.asarray([b["noisy"].shape[-1] for b in batch],
                         dtype=np.int64)
    max_len = int(max(max(b["noisy"].shape[-1] for b in batch),
                      max(b["clean"].shape[-1] for b in batch)
                      if has_clean else 0))
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < batch max length {max_len}")
        max_len = pad_to
    B = len(batch)
    noisy = np.zeros((B, max_len), dtype=np.float32)
    for i, b in enumerate(batch):
        noisy[i, :b["noisy"].shape[-1]] = b["noisy"]
    out = {"id": ids, "noisy": noisy, "lengths": lengths,
           "sr": batch[0]["sr"]}
    if has_clean:
        clean = np.zeros((B, max_len), dtype=np.float32)
        for i, b in enumerate(batch):
            clean[i, :b["clean"].shape[-1]] = b["clean"]
        out["clean"] = clean
    return out

from lct_gan_tpu_torch.data.audio_io import (load_mono_wave, read_scp,
                                             read_wav, resample,
                                             wav_num_samples, write_wav)
from lct_gan_tpu_torch.data.dataset import ScpDataset, collate
from lct_gan_tpu_torch.data.pipeline import (Prefetcher, adaptive_slices,
                                             batch_iterator, bucket_length)

__all__ = ["Prefetcher", "ScpDataset", "adaptive_slices", "batch_iterator",
           "bucket_length", "collate", "load_mono_wave", "read_scp",
           "read_wav", "resample", "wav_num_samples", "write_wav"]

from lct_gan_tpu_torch.data.audio_io import (load_mono_wave, read_scp,
                                             read_wav, resample, write_wav)
from lct_gan_tpu_torch.data.pipeline import (adaptive_slices, bucket_length,
                                             bucketed_batches)

__all__ = ["adaptive_slices", "bucket_length", "bucketed_batches",
           "load_mono_wave", "read_scp", "read_wav", "resample", "write_wav"]

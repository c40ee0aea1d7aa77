from lct_gan_tpu_torch.sigproc.stft import (
    ComplexSTFT,
    STFTConfig,
    apply_mask,
    compress,
    compute_compressed_irm,
    decompress,
    decompress_mask,
    hann_window,
    istft,
    magnitude,
    make_lct_stft,
    stft,
)

__all__ = [
    "ComplexSTFT",
    "STFTConfig",
    "apply_mask",
    "compress",
    "compute_compressed_irm",
    "decompress",
    "decompress_mask",
    "hann_window",
    "istft",
    "magnitude",
    "make_lct_stft",
    "stft",
]

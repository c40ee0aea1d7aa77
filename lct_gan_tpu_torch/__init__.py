"""LCT-GAN speech enhancement in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (sm_90a).

The JAX package `lct_gan_tpu` is the numerical reference; this package
imports nothing of it (nor JAX): what it needs from the reference's
numpy-only modules it keeps as its own copies. Entry points run on the
card unless the caller passes `device="cpu"`, and raise when no GPU is
visible. On CPU tensors every kernel wrapper computes its plain PyTorch
version; on CUDA tensors it launches its kernel or raises.

Ported so far is the serving side, waveform enhancement with fixed weights:

    STFT -> magnitude -> LctGenerator (encoder convs, LayerNorm,
    FTF blocks GRUf1 -> GRUt1 -> GRUf2, decoder) -> compressed mask -> iSTFT

with full or banded-causal time attention (`max_time_context`) at any
utterance length, and chunked streaming (`eval.StreamingEnhancer`).
"""

__all__ = ["__version__"]

__version__ = "0.1.0"

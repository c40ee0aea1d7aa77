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
utterance length, and chunked streaming (`eval.StreamingEnhancer`); and the
GAN train step (`train.make_train_step`, `train.make_eval_step`,
`train.create_state`): losses, the MPD / MSD discriminators, two AdamW
optimizers, and gradients through every kernel wrapper (the FTF block's
backward is its own CUDA kernel); and the training run around it: the
data pipeline (`data.ScpDataset`, `data.batch_iterator`, `data.Prefetcher`),
validation metrics (`metrics`), `.pt` checkpoints and resume
(`train.checkpoint`), `train.run_training` and the train CLI
(`python -m lct_gan_tpu_torch.train_cli`); and the export path: the four
kernels are `torch.library` custom ops (`torch.ops.lct_gan_tpu_torch.*`,
registered on import), so `export_model.export_enhancer` writes
`torch.export` programs per bucket shape, portable (ATen ops only) or with
the CUDA kernels kept, and `export_model.load_exported` serves them; with
the export CLI (`export_cli`), the metrics CLI (`metrics_cli`), the
comparison harness (`eval.compare`) and the B = 1 serving-latency tool
(`bench_serving_latency`).
"""

from lct_gan_tpu_torch import ops  # noqa: F401  (registers the kernel ops)

__all__ = ["__version__"]

__version__ = "0.1.0"

"""Chunked streaming in the port (lct_gan_tpu_torch/eval/streaming.py)
against the JAX package's: the chunking and crossfade copy bit for bit,
the port's StreamingEnhancer against the JAX one with the committed trained
weights and a banded configuration, and the infer CLI's --chunk_seconds
mode."""

import os

import numpy as np
import pytest

from lct_gan_tpu.eval.streaming import StreamingEnhancer as JaxStreaming
from lct_gan_tpu.eval.streaming import enhance_in_chunks as jax_chunks
from lct_gan_tpu_torch import infer as port_infer
from lct_gan_tpu_torch.data import read_wav, write_wav
from lct_gan_tpu_torch.eval import StreamingEnhancer, enhance_in_chunks

SR = 16000
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "train_demo", "g_params_best.npz")


def _fake_enhance(batch):
    """Deterministic, position-dependent per-row map, so a seam placed or
    weighted differently would show."""
    pos = np.linspace(0.5, 1.5, batch.shape[1], dtype=np.float32)
    return np.tanh(2.0 * batch) * pos + 0.01 * batch.sum(axis=1,
                                                         keepdims=True)


@pytest.mark.parametrize("seconds,chunk,overlap,max_batch", [
    (2.0, 0.5, 0.1, 32),   # tests/test_streaming.py geometries
    (0.3, 0.5, 0.1, 32),
    (2.3, 0.5, 0.1, 2),
    (0.5, 0.5, 0.1, 32),   # exactly one chunk
    (3.0, 1.0, 0.5, 3),    # overlap = half the chunk
])
def test_enhance_in_chunks_equals_jax(seconds, chunk, overlap, max_batch):
    wave = np.random.default_rng(int(seconds * 10)).standard_normal(
        int(seconds * SR)).astype(np.float32)
    kw = dict(sample_rate=SR, chunk_seconds=chunk, overlap_seconds=overlap,
              max_batch=max_batch)
    got = enhance_in_chunks(_fake_enhance, wave, **kw)
    want = jax_chunks(_fake_enhance, wave, **kw)
    assert got.shape == wave.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for fn in (enhance_in_chunks, jax_chunks):
        with pytest.raises(ValueError, match="at most half the chunk"):
            fn(_fake_enhance, wave, SR, chunk_seconds=1.0,
               overlap_seconds=0.51)


def test_streaming_enhancer_matches_jax():
    """3 s wave, 1 s chunks, 0.25 s overlap (4 chunks in one call),
    max_time_context = 16: the port in f32 on the CPU against the JAX class
    on its jnp path. Found max|diff| 6.0e-8."""
    wave = (0.1 * np.random.default_rng(11).standard_normal(3 * SR)).astype(
        np.float32)
    kw = dict(chunk_seconds=1.0, overlap_seconds=0.25, max_time_context=16)
    got = StreamingEnhancer(NPZ, device="cpu", precise=True, **kw)(wave)
    want = JaxStreaming(NPZ, **kw)(wave)
    assert got.shape == want.shape == wave.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_infer_cli_chunked(tmp_path):
    root = str(tmp_path / "data")
    rng = np.random.default_rng(4)
    os.makedirs(os.path.join(root, "noisy_test"))
    lens = {"a": 4000, "b": 9500, "c": 6100}
    for uid, n in lens.items():
        write_wav(os.path.join(root, "noisy_test", f"{uid}.wav"),
                  0.2 * rng.standard_normal(n).astype(np.float32), SR)
    with open(os.path.join(root, "test.scp"), "w") as f:
        f.write("\n".join(lens) + "\n")
    out = str(tmp_path / "chunked")
    port_infer.main(["--data_root", root, "--checkpoint", NPZ, "--device",
                     "cpu", "--output_dir", out, "--max_time_context", "16",
                     "--chunk_seconds", "0.25", "--chunk_overlap", "0.05"])
    se = StreamingEnhancer(NPZ, chunk_seconds=0.25, overlap_seconds=0.05,
                           max_time_context=16, device="cpu")
    for uid, n in lens.items():
        got, sr = read_wav(os.path.join(out, f"{uid}.wav"))
        assert sr == SR and got.shape == (1, n)
        noisy, _ = read_wav(os.path.join(root, "noisy_test", f"{uid}.wav"))
        np.testing.assert_allclose(got[0], se(noisy[0]),
                                   atol=1.0 / 32768 + 1e-6)

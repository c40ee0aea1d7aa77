"""The port's STFT / iSTFT / mask algebra (lct_gan_tpu_torch/sigproc)
against the JAX package's, on the same seeded numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu import sigproc as J
from lct_gan_tpu_torch import sigproc as P
from lct_gan_tpu_torch.sigproc.stft import _ola_envelope_inv_np

CFGS = [
    dict(n_fft=512),                      # the LCT STFT: hop 256, centre
    dict(n_fft=320, hop_length=80),       # hop does not split n_fft in 2
    dict(n_fft=256, center=False),
    dict(n_fft=512, win_length=400, hop_length=128),
]


def _wave(B=2, T=4000, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T)).astype(
        np.float32)


@pytest.mark.parametrize("kw", CFGS)
def test_stft_matches_jax(kw):
    x = _wave()
    want = np.asarray(J.stft(jnp.asarray(x), J.STFTConfig(**kw)))
    got = P.stft(torch.from_numpy(x), P.STFTConfig(**kw)).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert P.STFTConfig(**kw).finalize().num_frames(4000) == got.shape[-1]


def _envelope_scale(cfg, n_frames, length):
    """1 / (window-square OLA envelope), cut as istft cuts its output: a
    sample where the envelope is tiny (the signal's first and last window
    tails) divides FFT rounding by it, in both packages alike."""
    cfg = cfg.finalize()
    full = (n_frames - 1) * cfg.hop_length + cfg.n_fft
    inv = _ola_envelope_inv_np(cfg, n_frames, full)
    pad = cfg.n_fft // 2 if cfg.center else 0
    inv = inv[pad:] if length is not None else inv[pad:full - pad]
    if length is not None:
        inv = np.pad(inv, (0, max(0, length - inv.size)),
                     constant_values=1.0)[:length]
    return np.maximum(inv, 1.0)


@pytest.mark.parametrize("kw", CFGS)
@pytest.mark.parametrize("length", [None, 3900, 4000, 4200])
def test_istft_matches_jax(kw, length):
    """Round trip and the length trim / zero-pad rule."""
    x = _wave(seed=1)
    spec = np.asarray(J.stft(jnp.asarray(x), J.STFTConfig(**kw)))
    want = np.asarray(J.istft(jnp.asarray(spec), J.STFTConfig(**kw),
                              length=length))
    got = P.istft(torch.from_numpy(spec.copy()), P.STFTConfig(**kw),
                  length=length).numpy()
    assert got.shape == want.shape
    scale = _envelope_scale(P.STFTConfig(**kw), spec.shape[-1], length)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("four_d", [False, True])
def test_apply_mask_and_magnitude_match_jax(four_d):
    rng = np.random.default_rng(2)
    spec = (rng.standard_normal((2, 257, 20))
            + 1j * rng.standard_normal((2, 257, 20))).astype(np.complex64)
    mask = rng.uniform(-0.1, 1.0, (2, 257, 20)).astype(np.float32)
    if four_d:
        mask = mask[:, None]
    for compressed in (False, True):
        want = np.asarray(J.apply_mask(jnp.asarray(spec), jnp.asarray(mask),
                                       compressed=compressed, c=0.3))
        got = P.apply_mask(torch.from_numpy(spec), torch.from_numpy(mask),
                           compressed=compressed, c=0.3).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        P.magnitude(torch.from_numpy(spec)).numpy(),
        np.asarray(J.magnitude(jnp.asarray(spec))), rtol=1e-6)
    clean = spec * 0.5
    np.testing.assert_allclose(
        P.compute_compressed_irm(torch.from_numpy(clean),
                                 torch.from_numpy(spec)).numpy(),
        np.asarray(J.compute_compressed_irm(jnp.asarray(clean),
                                            jnp.asarray(spec))), rtol=1e-5)


def test_make_lct_stft_round_trip():
    x = torch.from_numpy(_wave(seed=3))
    s = P.make_lct_stft()
    y = s.istft(s(x), length=x.shape[-1])
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-5)

"""The port's training losses and TF features (lct_gan_tpu_torch/losses,
lct_gan_tpu_torch/sigproc/features.py) against the JAX package's, on the same
seeded numpy inputs. f32 throughout: 1e-5 relative unless stated."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from lct_gan_tpu import losses as jl
from lct_gan_tpu.sigproc import TFFeaturesConfig as JTFConfig
from lct_gan_tpu.sigproc import compute_tf_features as j_features
from lct_gan_tpu_torch import losses as tl
from lct_gan_tpu_torch.sigproc import (TFFeaturesConfig, compute_tf_features,
                                       reflect_pad)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _waves(seed, B=3, T=4000):
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal((B, T))).astype(np.float32)
    return noisy, clean


@pytest.mark.parametrize("compress_input,return_stfts", [
    (False, True), (True, False)])
def test_tf_features_match_jax(compress_input, return_stfts):
    noisy, clean = _waves(0)
    kw = dict(c=0.3, compress_input=compress_input, return_stfts=return_stfts)
    want = j_features(jnp.asarray(noisy), jnp.asarray(clean), JTFConfig(**kw))
    got = compute_tf_features(torch.from_numpy(noisy), torch.from_numpy(clean),
                              TFFeaturesConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        # Spectra: absolute against the largest bin (the two FFTs differ in
        # the last ulp). Magnitudes and masks: relative, 1e-4, since the
        # smallest bins (|X| ~ 1e-3) carry that ulp difference; found max
        # 6.7e-5, 99.9th percentile 5e-6.
        if k.endswith("stft"):
            scale = float(np.abs(np.asarray(want[k])).max())
            _close(got[k].numpy(), want[k], rtol=0, atol=1e-5 * scale)
        else:
            _close(got[k].numpy(), want[k], rtol=1e-4)


def test_tf_features_reject_bad_shapes():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="same shape"):
        compute_tf_features(x, torch.zeros(2, 101))
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        compute_tf_features(torch.zeros(100), torch.zeros(100))


@pytest.mark.parametrize("left,right", [(256, 256), (3, 0), (0, 10)])
def test_reflect_pad_equals_torch_reflect(left, right):
    x = torch.from_numpy(_waves(1, T=300)[0])
    want = F.pad(x[:, None], (left, right), mode="reflect")[:, 0]
    assert torch.equal(reflect_pad(x, left, right), want)


def test_mr_stft_loss_and_details_match_jax():
    noisy, clean = _waves(2)
    want, wd = jl.mr_stft_loss(jnp.asarray(noisy), jnp.asarray(clean))
    got, gd = tl.mr_stft_loss(torch.from_numpy(noisy),
                              torch.from_numpy(clean))
    _close(got.item(), want)
    assert set(gd) == set(wd)
    for k in wd:
        _close(gd[k].item(), wd[k])


def test_mr_stft_loss_per_sample_matches_jax_and_scalar():
    noisy, clean = _waves(3)
    want = jl.mr_stft_loss_per_sample(jnp.asarray(noisy), jnp.asarray(clean))
    got = tl.mr_stft_loss_per_sample(torch.from_numpy(noisy),
                                     torch.from_numpy(clean))
    assert got.shape == (3,)
    _close(got.numpy(), want)
    scalar, _ = tl.mr_stft_loss(torch.from_numpy(noisy),
                                torch.from_numpy(clean))
    _close(got.mean().item(), scalar.item(), rtol=1e-6)


def test_mr_stft_config_resolutions():
    cfg = tl.MRSTFTLossConfig()
    assert [(c.n_fft, c.hop_length, c.win_length)
            for c in cfg.stft_configs()] == [(320, 160, 320), (512, 256, 512),
                                             (768, 384, 768)]
    assert cfg.weights() == (1.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="2-D"):
        tl.mr_stft_loss(torch.zeros(4000), torch.zeros(4000))


def _logits(seed, n=4):
    rng = np.random.default_rng(seed)
    shapes = [(2, 1, 5, 2), (2, 1, 7, 3), (2, 1, 16), (2, 1, 8)][:n]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("loss_type", ["ls", "hinge"])
def test_discriminator_and_generator_losses_match_jax(loss_type):
    real, fake = _logits(4), _logits(5)
    jr, jf = [jnp.asarray(a) for a in real], [jnp.asarray(a) for a in fake]
    tr, tf = ([torch.from_numpy(a) for a in real],
              [torch.from_numpy(a) for a in fake])
    _close(tl.discriminator_loss(tr, tf, loss_type).item(),
           jl.discriminator_loss(jr, jf, loss_type))
    _close(tl.generator_adv_loss(tf, loss_type).item(),
           jl.generator_adv_loss(jf, loss_type))


def test_gan_losses_reject_bad_input():
    a = [torch.zeros(2, 1, 3)]
    with pytest.raises(ValueError, match="mismatch"):
        tl.discriminator_loss(a, a + a)
    with pytest.raises(ValueError, match="Unknown"):
        tl.discriminator_loss(a, a, "wgan")
    with pytest.raises(ValueError, match="Unknown"):
        tl.generator_adv_loss(a, "wgan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_matching_loss_matches_jax(dtype):
    """bf16 feature maps: the difference is taken in bf16 on both sides and
    the mean accumulates in f32 (its order differs: 1e-3 relative)."""
    rng = np.random.default_rng(6)
    shapes = [[(2, 16, 40), (2, 64, 10)], [(2, 32, 5, 3), (2, 1, 5, 3)]]
    real = [[rng.standard_normal(s).astype(np.float32) for s in ss]
            for ss in shapes]
    fake = [[rng.standard_normal(s).astype(np.float32) for s in ss]
            for ss in shapes]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.feature_matching_loss(
        [[jnp.asarray(a, dtype=jd) for a in ss] for ss in real],
        [[jnp.asarray(a, dtype=jd) for a in ss] for ss in fake])
    got = tl.feature_matching_loss(
        [[torch.from_numpy(a).to(td) for a in ss] for ss in real],
        [[torch.from_numpy(a).to(td) for a in ss] for ss in fake])
    assert got.dtype == torch.float32
    _close(got.item(), want, rtol=RTOL if dtype == "float32" else 1e-3)


def test_feature_matching_loss_rejects_mismatch():
    a = [[torch.zeros(2, 3)]]
    with pytest.raises(ValueError, match="outer-list"):
        tl.feature_matching_loss(a, a + a)
    with pytest.raises(ValueError, match="feature maps"):
        tl.feature_matching_loss(a, [[torch.zeros(2, 3)] * 2])
    assert tl.feature_matching_loss([], []).item() == 0.0


def test_mask_mse_loss_matches_jax_and_checks_shape():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (2, 257, 16)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 257, 16)).astype(np.float32)
    _close(tl.mask_mse_loss(torch.from_numpy(a), torch.from_numpy(b)).item(),
           jl.mask_mse_loss(jnp.asarray(a), jnp.asarray(b)))
    with pytest.raises(ValueError, match="Shape mismatch"):
        tl.mask_mse_loss(torch.zeros(2, 3), torch.zeros(2, 4))


def test_flatten_logits_lists_keeps_order():
    a, b, c = (torch.full((1,), float(i)) for i in range(3))
    assert [t.item() for t in tl.flatten_logits_lists([a, b], [c])] == [0, 1, 2]

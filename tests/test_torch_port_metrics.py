"""The port's metric copies (lct_gan_tpu_torch/metrics) against the JAX
package's on seeded 1 s waves: SI-SDR (single and batched), STOI and ESTOI
(also resampled from 48 kHz), fwSegSNR, the vendored P.862 estimator (wide
and narrow band), the gated wrappers and the per-pair evaluator. They are
the same numpy code, so every value must be bit-equal; the gates must hold
as the JAX package sets them (certified PESQ NaN without its wheel, the
estimate in its own slot)."""

import math

import numpy as np
import pytest

from lct_gan_tpu import metrics as jax_metrics
from lct_gan_tpu_torch import metrics as port_metrics
from lct_gan_tpu_torch.data import write_wav

SR = 16000


@pytest.fixture(scope="module")
def waves():
    """A 1 s tone-plus-noise 'clean' wave, a noisier 'enhanced' one and a
    48 kHz pair for the resampling paths."""
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    clean = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal(SR))
    enhanced = clean + 0.05 * rng.standard_normal(SR)
    t48 = np.arange(3 * SR) / (3 * SR)
    clean48 = 0.3 * np.sin(2 * np.pi * 330 * t48) + 0.01 * rng.standard_normal(
        3 * SR)
    return (clean.astype(np.float32), enhanced.astype(np.float32),
            clean48.astype(np.float32),
            (clean48 + 0.05 * rng.standard_normal(3 * SR)).astype(np.float32))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=True), (a, b)


@pytest.mark.parametrize("name,call", [
    ("si_sdr", lambda m, c, e, c48, e48: m.si_sdr(c, e)),
    ("batch_si_sdr", lambda m, c, e, c48, e48: m.batch_si_sdr(
        np.stack([c, e, c]), np.stack([e, c, e + 0.1 * c]))),
    ("stoi", lambda m, c, e, c48, e48: m.stoi(c, e, SR)),
    ("estoi", lambda m, c, e, c48, e48: m.stoi(c, e, SR, extended=True)),
    ("stoi_48k", lambda m, c, e, c48, e48: m.stoi(c48, e48, 3 * SR)),
    ("fwsegsnr", lambda m, c, e, c48, e48: m.fwsegsnr(c, e, SR)),
    ("pesq_p862_wb", lambda m, c, e, c48, e48: m.pesq_p862(c, e, SR, "wb")),
    ("pesq_p862_nb", lambda m, c, e, c48, e48: m.pesq_p862(c, e, SR, "nb")),
    ("pesq_estimate", lambda m, c, e, c48, e48: m.pesq_estimate(c, e, SR)),
    ("stoi_score", lambda m, c, e, c48, e48: m.stoi_score(c, e[:-100], SR)),
    ("pesq_score", lambda m, c, e, c48, e48: m.pesq_score(c, e, SR)),
])
def test_metric_copies_are_bit_equal(waves, name, call):
    got, want = call(port_metrics, *waves), call(jax_metrics, *waves)
    _same(got, want)
    assert np.all(np.isfinite(got)) or name == "pesq_score"


def test_gates_follow_the_jax_package(waves):
    clean, enhanced = waves[:2]
    assert port_metrics.pesq_available() == jax_metrics.pesq_available()
    if not port_metrics.pesq_available():
        assert math.isnan(port_metrics.pesq_score(clean, enhanced, SR))
        # The estimate falls back to the vendored P.862.
        _same(port_metrics.pesq_estimate(clean, enhanced, SR),
              port_metrics.pesq_p862(clean, enhanced, SR, "wb"))


@pytest.mark.parametrize("kw", [
    {}, {"estoi": True, "include_fwsegsnr": False},
    {"include_pesq": False, "include_si_sdr": False}])
def test_compute_metrics_for_pair_is_bit_equal(tmp_path, waves, kw):
    clean, enhanced = waves[:2]
    c, e = str(tmp_path / "c.wav"), str(tmp_path / "e.wav")
    write_wav(c, clean, SR)
    write_wav(e, enhanced, SR)
    got = port_metrics.compute_metrics_for_pair(c, e, SR, **kw)
    want = jax_metrics.compute_metrics_for_pair(c, e, SR, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    if not port_metrics.pesq_available() and kw.get("include_pesq", True):
        # Certified slot NaN, the estimate in its own slot.
        assert math.isnan(got["pesq_wb"]) and math.isfinite(
            got["pesq_wb_est"])

"""The whole slice on the CPU: the port's LctEnhancer (plain path) against
the JAX package's LctEnhancer on its jnp path (no Pallas kernel), with the
committed trained demo weights and the same seeded inputs.

Both run all-f32 here (the port with precise=True), so the comparison is of
the algorithm; found max|diff| <= 6e-7 on the mask and <= 6e-8 on the
waveform at the B=2 x 1 s, bucketed and composed-path (L = 516) cases."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.models.generator import LCTGeneratorConfig
from lct_gan_tpu.models.generator import LctEnhancer as JaxEnhancer
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu_torch.convert import load_enhancer, read_npz_params
from lct_gan_tpu_torch.eval import make_enhance
from lct_gan_tpu_torch.models import attention as port_attention
from lct_gan_tpu_torch.models import generator as port_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "train_demo", "g_params_best.npz")

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params, _ = read_npz_params(NPZ)
    params = jax.tree.map(jnp.asarray, params)
    jax_enh = JaxEnhancer()
    jax_fn = jax.jit(lambda x, l: jax_enh.apply({"params": params}, x, l))
    return jax_fn, load_enhancer(NPZ, device="cpu", precise=True)


CASES = [
    # name, B, T, lengths
    ("fixed_2x1s", 2, 16000, None),
    ("bucketed_lengths", 3, 20480, [20480, 17000, 9001]),
    # bottleneck T = 516 > 512: the time block takes the composed path
    # (the LN1 + grouped GRU operator, then the MHSA wrapper).
    ("composed_time_block", 1, 131072, None),
]


@pytest.mark.parametrize("name,B,T,lengths", CASES)
def test_enhancer_matches_jax_jnp_path(models, monkeypatch, name, B, T,
                                       lengths):
    jax_fn, port = models
    x = (0.1 * np.random.default_rng(B * T).standard_normal((B, T))
         ).astype(np.float32)
    with pallas_override(None):
        jw, jm = jax_fn(jnp.asarray(x), None if lengths is None
                        else jnp.asarray(lengths, jnp.int32))
    calls = []
    gru_op = port_generator.fused_grouped_gru

    def spy(seq, *a, **k):
        calls.append(tuple(seq.shape))
        return gru_op(seq, *a, **k)

    monkeypatch.setattr(port_generator, "fused_grouped_gru", spy)
    with torch.inference_mode():
        pw, pm = port(torch.from_numpy(x), None if lengths is None
                      else torch.tensor(lengths))
    # Only the composed time block runs the LN1 + GRU operator.
    assert calls == ([(33, 516, 64)] if name == "composed_time_block"
                     else [])
    assert pm.shape == jm.shape and pw.shape == jw.shape == (B, T)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=ATOL)
    if lengths is not None:
        # The key mask engaged: a short row differs from its unmasked run.
        with torch.inference_mode():
            unmasked, _ = port(torch.from_numpy(x))
        assert not torch.allclose(unmasked[2], pw[2])


def test_banded_enhancer_matches_jax_jnp_path(monkeypatch):
    """max_time_context = 64, one row of the 196,608-sample bucket with
    lengths: bottleneck S = 772 >= 769, so the port's time attention takes
    the banded kernel wrapper (its plain version here) and the JAX one its
    blocked jnp path. Found max|diff| 5.4e-7 (mask), 6.7e-8 (waveform)."""
    T, lengths = 196608, [190000]
    params, _ = read_npz_params(NPZ)
    params = jax.tree.map(jnp.asarray, params)
    jax_enh = JaxEnhancer(gen_cfg=LCTGeneratorConfig(max_time_context=64))
    x = np.zeros((1, T), np.float32)
    x[0, :lengths[0]] = 0.1 * np.random.default_rng(9).standard_normal(
        lengths[0])
    with pallas_override(None):
        jw, jm = jax.jit(lambda x, l: jax_enh.apply({"params": params}, x, l))(
            jnp.asarray(x), jnp.asarray(lengths, jnp.int32))
    port = load_enhancer(NPZ, device="cpu", precise=True, max_time_context=64)
    calls = []
    banded = port_attention.banded_mhsa

    def spy(*a, **k):
        calls.append(a[0].shape)
        return banded(*a, **k)

    monkeypatch.setattr(port_attention, "banded_mhsa", spy)
    with torch.inference_mode():
        pw, pm = port(torch.from_numpy(x), torch.tensor(lengths))
    assert calls == [(33, 772, 64)]
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=ATOL)


def test_serving_bf16_mode_stays_in_the_kernel_band(models):
    """make_enhance in the default (bf16-rounding) mode against the f32 run:
    the difference is the TPU kernel's bf16 noise, not a fault."""
    _, port = models
    x = (0.1 * np.random.default_rng(5).standard_normal((2, 16000))
         ).astype(np.float32)
    bf16 = make_enhance(load_enhancer(NPZ, device="cpu"))(x).numpy()
    with torch.inference_mode():
        f32, _ = port(torch.from_numpy(x))
    err = np.abs(bf16 - f32.numpy())
    assert 0 < err.max() < 1e-2

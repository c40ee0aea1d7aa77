"""The port's MHSA (lct_gan_tpu_torch/ops/attention.py) against the JAX
package's: `mhsa_reference` in f32, and the bf16-mode plain version against
the Pallas kernel `fused_mhsa` in interpret mode, with and without a band
and a per-key bias. Also the module's dispatch rules."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu.ops.attention import fused_mhsa as jax_fused
from lct_gan_tpu.ops.attention import mhsa_reference as jax_reference
from lct_gan_tpu_torch.models.attention import MultiHeadSelfAttention
from lct_gan_tpu_torch.ops.attention import (fused_mhsa, mhsa_reference,
                                             mhsa_scratch)
from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa_reference


def _inputs(seed, N, L, use_kb, E=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, E)).astype(np.float32)
    p = [rng.uniform(-0.25, 0.25, s).astype(np.float32)
         for s in ((E, 3 * E), (3 * E,), (E, E), (E,))]
    kb = None
    if use_kb:
        valid = rng.integers(L // 2, L + 1, size=N)
        kb = np.where(np.arange(L)[None, :] < valid[:, None], 0.0,
                      -1e30).astype(np.float32)
    return x, p, kb


CASES = [(None, False), (None, True), (5, False)]


@pytest.mark.parametrize("lookback,use_kb", CASES)
def test_plain_f32_matches_jax_reference(lookback, use_kb):
    x, p, kb = _inputs(0, 5, 24, use_kb)
    want = np.asarray(jax_reference(
        jnp.asarray(x), *map(jnp.asarray, p), num_heads=4, lookback=lookback,
        key_bias=None if kb is None else jnp.asarray(kb)))
    got = mhsa_reference(
        torch.from_numpy(x), *map(torch.from_numpy, p), num_heads=4,
        lookback=lookback,
        key_bias=None if kb is None else torch.from_numpy(kb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("lookback,use_kb", CASES)
def test_wrapper_bf16_matches_jax_interpret_kernel(lookback, use_kb):
    x, p, kb = _inputs(1, 6, 24, use_kb)
    want = np.asarray(jax_fused(
        jnp.asarray(x), *map(jnp.asarray, p), num_heads=4, lookback=lookback,
        key_bias=None if kb is None else jnp.asarray(kb), block_seqs=2,
        interpret=True))
    ref32 = mhsa_reference(
        torch.from_numpy(x), *map(torch.from_numpy, p), num_heads=4,
        lookback=lookback,
        key_bias=None if kb is None else torch.from_numpy(kb)).numpy()
    before = fused_mhsa.launches
    got = fused_mhsa(
        torch.from_numpy(x), *map(torch.from_numpy, p), num_heads=4,
        lookback=lookback,
        key_bias=None if kb is None else torch.from_numpy(kb),
        precise=False).numpy()
    assert fused_mhsa.launches == before  # CPU: plain version, no launch
    # Matched rounding points: far closer to the kernel than f32 is.
    err, err32 = np.abs(got - want), np.abs(ref32 - want)
    assert err.max() < 2e-3 and err.max() < 0.5 * err32.max()
    assert err.mean() < 0.1 * err32.mean()


def test_module_dispatch_rules():
    torch.manual_seed(0)
    attn = MultiHeadSelfAttention(64, 4)
    x = torch.randn(2, 40, 64)
    in_w, in_b, out_w, out_b = attn.kernel_params()
    with torch.no_grad():
        # S <= 1024 goes through the kernel wrapper: on the CPU its plain
        # version, in the requested mode.
        for precise in (True, False):
            got = attn(x, precise=precise)
            want = mhsa_reference(x, in_w, in_b, out_w, out_b,
                                  precise=precise)
            assert torch.equal(got, want)
        # A band at S >= 769 goes through the banded kernel wrapper: on
        # the CPU its O(S * W) plain version.
        xl = torch.randn(1, 800, 64)
        got = attn(xl, lookback=8, precise=True)
        want = banded_mhsa_reference(xl, in_w, in_b, out_w, out_b,
                                     num_heads=4, lookback=8)
        assert torch.equal(got, want)
        # Above 1024 the unbanded attention is the plain f32 path.
        xl = torch.randn(1, 1030, 64)
        got = attn(xl)
        want = mhsa_reference(xl, in_w, in_b, out_w, out_b)
        assert torch.equal(got, want)
    assert fused_mhsa.launches == 0


@pytest.mark.parametrize("precise", [False, True])
def test_kernel_scratch_per_mode(precise):
    """The wrapper allocates only what the mode's kernels write: q, k, v as
    bf16 for the tensor-core design (the context stays in registers), qkv
    and the context in f32 for the all-f32 one. On the CPU nothing is
    launched and no design is recorded."""
    got = [(name, shape, dtype) for name, shape, dtype in
           mhsa_scratch(777, precise)]
    if precise:
        assert got == [("qkv", (777, 192), torch.float32),
                       ("ctx", (777, 64), torch.float32)]
    else:
        assert got == [("qkv", (777, 192), torch.bfloat16)]
    design = fused_mhsa.design
    x, p, _ = _inputs(2, 2, 8, False)
    fused_mhsa(torch.from_numpy(x), *map(torch.from_numpy, p),
               precise=precise)
    assert fused_mhsa.design == design

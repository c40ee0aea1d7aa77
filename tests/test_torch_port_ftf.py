"""The port's FTF block (lct_gan_tpu_torch/ops/ftf.py) against the JAX
package's: the plain version in f32 against `ftf_block_reference`, and in
bf16 mode against the Pallas kernel in interpret mode, on the same seeded
numpy inputs. On the CPU the wrapper computes the plain version and counts
no launch."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu.ops.ftf import ftf_block_reference as jax_reference
from lct_gan_tpu.ops.ftf import fused_ftf_block as jax_fused
from lct_gan_tpu_torch.ops.attention import kernel_design
from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference, ftf_scratch,
                                       fused_ftf_block)

ORDER = ("ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih", "b_hh",
         "ln2_scale", "ln2_bias", "in_w", "in_b", "out_w", "out_b",
         "lin_w", "lin_b")


def make_params(seed, bidirectional, C=64, G=4):
    rng = np.random.default_rng(seed)
    D = 2 if bidirectional else 1
    H = C // G

    def u(shape, b=0.25):
        return rng.uniform(-b, b, shape).astype(np.float32)

    return dict(
        ln1_scale=1.0 + 0.1 * u((C,)), ln1_bias=0.1 * u((C,)),
        w_ih=u((D, G, H, 3 * H)), w_hh=u((D, G, H, 3 * H)),
        b_ih=u((D, G, 3 * H)), b_hh=u((D, G, 3 * H)),
        ln2_scale=1.0 + 0.1 * u((C,)), ln2_bias=0.1 * u((C,)),
        in_w=u((C, 3 * C)), in_b=0.1 * u((3 * C,)),
        out_w=u((C, C)), out_b=0.1 * u((C,)),
        lin_w=u(((2 * C if bidirectional else C), C)), lin_b=0.1 * u((C,)))


def key_bias_tail(rng, N, L):
    valid = rng.integers(L // 2, L + 1, size=N)
    return np.where(np.arange(L)[None, :] < valid[:, None], 0.0,
                    -1e30).astype(np.float32)


CASES = [
    # name, N, L, bidirectional, lookback, key_bias
    ("freq", 12, 17, True, None, False),
    ("time", 6, 40, False, None, False),
    ("time_lookback", 6, 40, False, 7, False),
    ("time_key_bias", 6, 40, False, None, True),
]


def _inputs(N, L, bidi, use_kb, seed=0):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    kb = key_bias_tail(rng, N, L) if use_kb else None
    return x, make_params(seed, bidi), kb


def _torch_args(x, p):
    return [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]


def _jax_args(x, p):
    return [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in ORDER]


@pytest.mark.parametrize("name,N,L,bidi,lookback,use_kb", CASES)
def test_plain_f32_matches_jax_reference(name, N, L, bidi, lookback, use_kb):
    x, p, kb = _inputs(N, L, bidi, use_kb)
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback)
    want = np.asarray(jax_reference(
        *_jax_args(x, p), key_bias=None if kb is None else jnp.asarray(kb),
        **kw))
    got = ftf_block_reference(
        *_torch_args(x, p), key_bias=None if kb is None
        else torch.from_numpy(kb), precise=True, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,N,L,bidi,lookback,use_kb", CASES)
def test_wrapper_bf16_matches_jax_interpret_kernel(name, N, L, bidi,
                                                   lookback, use_kb):
    """bf16 mode rounds at the TPU kernel's points, so it tracks the
    interpret-mode kernel far inside the kernel-vs-f32 band of
    tests/test_pallas_ftf.py (3e-2, corr > 0.9995): what remains is f32 sum
    order moving a value across a bf16 rounding boundary."""
    x, p, kb = _inputs(N, L, bidi, use_kb, seed=1)
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback)
    want = np.asarray(jax_fused(
        *_jax_args(x, p), key_bias=None if kb is None else jnp.asarray(kb),
        block_seqs=8, sub=4, interpret=True, **kw))
    before = fused_ftf_block.launches
    got = fused_ftf_block(
        *_torch_args(x, p), key_bias=None if kb is None
        else torch.from_numpy(kb), precise=False, **kw).numpy()
    assert fused_ftf_block.launches == before  # CPU: plain version, no launch
    # Found: max 3.6e-3..6.3e-3 and mean 0.8e-5..4.7e-5, against max
    # 1.6e-2..2.3e-2 and mean 1.6e-3..2.3e-3 for the f32 reference.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.abs(got - want).mean() < 2e-4
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


def test_precise_wrapper_is_the_reference_on_cpu():
    x, p, _ = _inputs(5, 9, True, False, seed=2)
    kw = dict(bidirectional=True, num_heads=4, precise=True)
    a = fused_ftf_block(*_torch_args(x, p), **kw)
    b = ftf_block_reference(*_torch_args(x, p), **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("precise", [False, True])
def test_kernel_scratch_per_mode(D, precise):
    """The wrapper allocates only what the mode's kernels write: in bf16
    mode the hiddens (f32, kept for the backward), q, k, v in bf16, s = x +
    g and, for the frequency block (lin_in = 128), bf16(g); the f32 design
    writes the GRU input projection, the hiddens, qkv and the context. The
    entries come in the C entry point's order, a None slot standing for the
    null gb of the time block."""
    lin_in = 64 * D
    got = ftf_scratch(1000, D, lin_in, precise)
    hid = ("hid", (D, 1000, 64), torch.float32)
    if precise:
        want = [("xp", (1000, D * 192), torch.float32), hid,
                ("qkv", (1000, 192), torch.float32),
                ("ctx", (1000, 64), torch.float32)]
    else:
        want = [hid, ("qkv", (1000, 192), torch.bfloat16),
                ("s", (1000, 64), torch.float32),
                ("gb", (1000, 64), torch.bfloat16) if D == 2 else None]
    assert got == want
    assert kernel_design(precise) == ("simt-f32" if precise else "tc-bf16")

"""The port's FTF-block backward (lct_gan_tpu_torch/ops/ftf_bwd.py) and the
autograd of every kernel wrapper, on the CPU.

  * `ftf_bwd_reference` against the JAX package's backward kernel
    `fused_ftf_bwd` run in interpret mode, on the same seeded inputs and
    the same hiddens: precise against precise (2e-5, the JAX package's own
    band for this comparison), bf16 mode against the kernel in bf16;
  * gradients through `fused_ftf_block` (its autograd Function: the saved
    hiddens and the plain backward on the CPU, or the f32 recompute with
    key_bias) against torch.autograd through `ftf_block_reference`;
  * gradients through `fused_mhsa` and `banded_mhsa` against autograd
    through their plain versions.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu.ops.ftf_bwd import fused_ftf_bwd as jax_fused_ftf_bwd
from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, fused_ftf_block
from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd, ftf_bwd_reference

from test_torch_port_ftf import ORDER, key_bias_tail, make_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(N, L, bidi, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    w = rng.standard_normal((N, L, 64)).astype(np.float32)
    p = make_params(seed, bidi)
    return x, w, [p[k] for k in ORDER]


def _jax_hid(hid, N, L):
    """The port's hid [D, N*L, C] -> the JAX kernel's [N, L, D*C]."""
    D = hid.shape[0]
    return hid.reshape(D, N, L, 64).permute(1, 2, 0, 3).reshape(N, L, D * 64)


BWD_CASES = [(True, None), (False, None), (False, 5)]


@pytest.mark.parametrize("bidi,lookback", BWD_CASES)
def test_precise_plain_backward_matches_jax_kernel(bidi, lookback):
    """On the exact f32 reference hiddens (tests/test_pallas_ftf.py:138-168:
    N = 6, L = 9)."""
    N, L = 6, 9
    x, w, p = _inputs(N, L, bidi, seed=4)
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback)
    _, hid = ftf_block_reference(torch.from_numpy(x), *tp, precise=True,
                                 return_hidden=True, **kw)
    got = ftf_bwd_reference(torch.from_numpy(x), *tp, hid,
                            torch.from_numpy(w), precise=True, **kw)
    want = jax_fused_ftf_bwd(
        jnp.asarray(x), *map(jnp.asarray, p),
        jnp.asarray(_jax_hid(hid, N, L).numpy()), jnp.asarray(w),
        block_seqs=4, sub=2, interpret=True, precise=True, **kw)
    assert len(got) == len(want) == 15
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("bidi,lookback", BWD_CASES)
def test_bf16_plain_backward_matches_jax_kernel(bidi, lookback):
    """bf16 mode rounds where the TPU kernel rounds; what remains is f32 sum
    order moving a value across a bf16 rounding boundary. Found: <= 1.8e-4
    of each gradient's largest magnitude, where the f32 backward is 0.11-0.21
    away."""
    N, L = 6, 9
    x, w, p = _inputs(N, L, bidi, seed=5)
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback)
    _, hid = ftf_block_reference(torch.from_numpy(x), *tp, precise=False,
                                 return_hidden=True, **kw)
    got = ftf_bwd_reference(torch.from_numpy(x), *tp, hid,
                            torch.from_numpy(w), precise=False, **kw)
    want = jax_fused_ftf_bwd(
        jnp.asarray(x), *map(jnp.asarray, p),
        jnp.asarray(_jax_hid(hid, N, L).numpy()), jnp.asarray(w),
        block_seqs=4, sub=2, interpret=True, precise=False, **kw)
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-3 * scale
        assert np.corrcoef(a.numpy().ravel(), b.ravel())[0, 1] > 0.9999


def _grads(fn, leaves, w, **kw):
    leaves = [t.clone().requires_grad_() for t in leaves]
    return torch.autograd.grad((fn(*leaves, **kw) * w).sum(), leaves)


FN_CASES = [
    # name, N, L, bidirectional, lookback, key_bias
    ("freq", 5, 11, True, None, False),
    ("time", 4, 20, False, None, False),
    ("time_lookback", 4, 20, False, 3, False),
    ("time_key_bias", 4, 20, False, None, True),
]


@pytest.mark.parametrize("name,N,L,bidi,lookback,use_kb", FN_CASES)
def test_fused_ftf_block_grads_match_autograd(name, N, L, bidi, lookback,
                                              use_kb):
    """precise: the hand-derived backward (or, with key_bias, the f32
    recompute) equals autograd through the f32 plain forward to sum-order
    noise."""
    x, w, p = _inputs(N, L, bidi, seed=6)
    kb = (torch.from_numpy(key_bias_tail(np.random.default_rng(1), N, L))
          if use_kb else None)
    leaves = [torch.from_numpy(a) for a in [x] + p]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              key_bias=kb, precise=True)
    before = fused_ftf_bwd.launches
    got = _grads(fused_ftf_block, leaves, torch.from_numpy(w), **kw)
    want = _grads(ftf_block_reference, leaves, torch.from_numpy(w), **kw)
    assert fused_ftf_bwd.launches == before   # CPU: plain version
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_bf16_block_grads_track_f32_autograd():
    """The default (bf16) block trains through its own rounded backward:
    a noise band around the f32 gradients, as tests/test_pallas_ftf.py's
    test_fused_ftf_grad_parity states it."""
    x, w, p = _inputs(4, 9, True, seed=7)
    leaves = [torch.from_numpy(a) for a in [x] + p]
    kw = dict(bidirectional=True, num_heads=4)
    got = _grads(fused_ftf_block, leaves, torch.from_numpy(w), precise=False,
                 **kw)
    want = _grads(ftf_block_reference, leaves, torch.from_numpy(w),
                  precise=True, **kw)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 0.2 * b.abs().max()
        assert np.corrcoef(a.flatten(), b.flatten())[0, 1] > 0.995


def test_no_hidden_kept_without_grad():
    x, _, p = _inputs(3, 7, True, seed=8)
    leaves = [torch.from_numpy(a) for a in [x] + p]
    out = fused_ftf_block(*leaves, bidirectional=True)
    assert out.grad_fn is None and not out.requires_grad


ATTN_CASES = [
    # wrapper, plain version, lookback, key_bias
    (fused_mhsa, mhsa_reference, None, False),
    (fused_mhsa, mhsa_reference, 4, True),
    (banded_mhsa, banded_mhsa_reference, 4, False),
    (banded_mhsa, banded_mhsa_reference, 7, True),
]


@pytest.mark.parametrize("wrapper,plain,lookback,use_kb", ATTN_CASES)
def test_attention_wrapper_grads_equal_plain_autograd(wrapper, plain,
                                                      lookback, use_kb):
    """The backward recomputes the f32 plain version under autograd, as the
    JAX package's custom VJPs do; key_bias is a constant."""
    rng = np.random.default_rng(9)
    N, S = 3, 21
    x = torch.from_numpy(rng.standard_normal((N, S, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, S, 64)).astype(np.float32))
    params = [torch.from_numpy(rng.uniform(-0.25, 0.25, s).astype(np.float32))
              for s in ((64, 192), (192,), (64, 64), (64,))]
    kb = (torch.from_numpy(key_bias_tail(rng, N, S)) if use_kb else None)
    kw = dict(num_heads=4, lookback=lookback, key_bias=kb)
    got = _grads(wrapper, [x] + params, w, **kw)
    want = _grads(plain, [x] + params, w, precise=True, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

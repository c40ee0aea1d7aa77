"""The port's banded attention (lct_gan_tpu_torch/ops/banded_attention.py)
against the JAX package's: the plain version in f32 against
`banded_mhsa_reference`, the bf16-mode plain version against the Pallas
kernel `banded_mhsa` in interpret mode, rows whose whole band is
key-masked, and the module's dispatch between the banded and MHSA kernels.

Found at the six shapes: f32 max |diff| <= 2.4e-7 (tolerance 1e-5); bf16
mode against the interpret-mode kernel max |diff| <= 7.9e-4 and mean <=
1.2e-6, where the f32 reference is 6.8e-3 max and 4.6e-4..6.2e-4 mean away."""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu.models.attention import (
    MultiHeadSelfAttention as JaxMultiHeadSelfAttention)
from lct_gan_tpu.ops.banded_attention import banded_mhsa as jax_banded
from lct_gan_tpu.ops.banded_attention import (
    banded_mhsa_reference as jax_reference)
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu_torch.models import attention as port_attention
from lct_gan_tpu_torch.models.attention import MultiHeadSelfAttention
from lct_gan_tpu_torch.ops import _build
from lct_gan_tpu_torch.ops.attention import fused_mhsa
from lct_gan_tpu_torch.ops.banded_attention import (BANDED_ENTRY, banded_mhsa,
                                                    banded_mhsa_reference,
                                                    banded_scratch)


def _params(seed=0, E=64):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(s)).astype(np.float32)
            for s in ((E, 3 * E), (3 * E,), (E, E), (E,))]


def _inputs(B, S, with_bias, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, 64)).astype(
        np.float32)
    kb = None
    if with_bias:
        kb = np.zeros((B, S), np.float32)
        kb[0, S - 9:] = -1e30  # a padded tail on row 0
    return x, kb


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


# tests/test_pallas_banded.py's shapes: (B, S, W, key_bias?)
SHAPES = [
    (2, 200, 64, False),
    (2, 200, 64, True),
    (1, 256, 64, False),
    (1, 641, 64, True),
    (2, 200, 32, False),
    (1, 130, 100, True),
]


@pytest.mark.parametrize("B,S,W,with_bias", SHAPES)
def test_plain_f32_matches_jax_reference(B, S, W, with_bias):
    p = _params()
    x, kb = _inputs(B, S, with_bias)
    want = np.asarray(jax_reference(
        jnp.asarray(x), *map(jnp.asarray, p), num_heads=4, lookback=W,
        key_bias=_jnp(kb)))
    got = banded_mhsa_reference(
        torch.from_numpy(x), *map(torch.from_numpy, p), num_heads=4,
        lookback=W, key_bias=_torch(kb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,S,W,with_bias", SHAPES)
def test_wrapper_bf16_matches_jax_interpret_kernel(B, S, W, with_bias):
    p = _params(2)
    x, kb = _inputs(B, S, with_bias, seed=3)
    want = np.asarray(jax_banded(
        jnp.asarray(x), *map(jnp.asarray, p), num_heads=4, lookback=W,
        key_bias=_jnp(kb), interpret=True))
    tp = list(map(torch.from_numpy, p))
    ref32 = banded_mhsa_reference(torch.from_numpy(x), *tp, num_heads=4,
                                  lookback=W, key_bias=_torch(kb)).numpy()
    before = banded_mhsa.launches
    got = banded_mhsa(torch.from_numpy(x), *tp, num_heads=4, lookback=W,
                      key_bias=_torch(kb), precise=False).numpy()
    assert banded_mhsa.launches == before  # CPU: plain version, no launch
    # Matched rounding points: far closer to the kernel than f32 is.
    err, err32 = np.abs(got - want), np.abs(ref32 - want)
    assert err.max() < 2e-3 and err.max() < 0.5 * err32.max()
    assert err.mean() < 0.1 * err32.mean()


def test_fully_key_masked_band_is_uniform():
    """Queries whose every in-band key carries -1e30 (-1e30 + s == -1e30 in
    f32) attend uniformly over their band, as the JAX paths give, and stay
    finite."""
    B, S, W = 1, 200, 16
    p = _params(4)
    x, _ = _inputs(B, S, False, seed=5)
    kb = np.zeros((B, S), np.float32)
    kb[:, 100:] = -1e30  # queries q >= 116 see no unmasked key
    tx, tp, tkb = torch.from_numpy(x), list(map(torch.from_numpy, p)), \
        torch.from_numpy(kb)
    got = banded_mhsa_reference(tx, *tp, num_heads=4, lookback=W,
                                key_bias=tkb)
    assert torch.isfinite(got).all()
    want = np.asarray(jax_reference(jnp.asarray(x), *map(jnp.asarray, p),
                                    num_heads=4, lookback=W,
                                    key_bias=jnp.asarray(kb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # Uniform over [q - W, q]: the mean of v over the band, projected.
    v = (tx @ tp[0] + tp[1])[..., 128:]
    mean_v = torch.stack([v[:, q - W:q + 1].mean(dim=1)
                          for q in range(116, S)], dim=1)
    uniform = mean_v @ tp[2] + tp[3]
    np.testing.assert_allclose(got[:, 116:].numpy(), uniform.numpy(),
                               rtol=0, atol=1e-5)


def test_module_dispatch(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(port_attention, name, wrapped)

    spy("banded_mhsa", banded_mhsa)
    spy("fused_mhsa", fused_mhsa)
    torch.manual_seed(0)
    attn = MultiHeadSelfAttention(64, 4)
    with torch.no_grad():
        attn(torch.randn(1, 800, 64), lookback=64)
        assert calls == ["banded_mhsa"]
        attn(torch.randn(1, 700, 64), lookback=64)
        assert calls == ["banded_mhsa", "fused_mhsa"]
    assert banded_mhsa.launches == 0 and fused_mhsa.launches == 0


def test_module_matches_jax_jnp_path():
    """S = 800, W = 64 with a key mask: the port's module (banded plain
    version, f32) against the JAX module on its jnp path."""
    S, W = 800, 64
    in_w, in_b, out_w, out_b = _params(6)
    x, _ = _inputs(2, S, False, seed=7)
    kb = np.zeros((2, S), np.float32)
    kb[1, 700:] = -1e30
    params = {"in_proj_kernel": in_w, "in_proj_bias": in_b,
              "out_proj_kernel": out_w, "out_proj_bias": out_b}
    with pallas_override(None):
        want = np.asarray(JaxMultiHeadSelfAttention(64, 4).apply(
            {"params": {k: jnp.asarray(v) for k, v in params.items()}},
            jnp.asarray(x), lookback=W, key_bias=jnp.asarray(kb)))
    attn = MultiHeadSelfAttention(64, 4)
    attn.load_state_dict({
        "in_proj_weight": torch.from_numpy(in_w.T.copy()),
        "in_proj_bias": torch.from_numpy(in_b),
        "out_proj.weight": torch.from_numpy(out_w.T.copy()),
        "out_proj.bias": torch.from_numpy(out_b)})
    with torch.no_grad():
        got = attn(torch.from_numpy(x), lookback=W,
                   key_bias=torch.from_numpy(kb), precise=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wrapper_rejects_a_negative_lookback():
    x = torch.zeros((1, 4, 64))
    p = [torch.zeros(s) for s in ((64, 192), (192,), (64, 64), (64,))]
    with pytest.raises(ValueError, match="lookback"):
        banded_mhsa(x, *p, lookback=-1)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("in_registers", [True, False])
def test_kernel_scratch_per_mode(in_registers, precise):
    """The wrapper allocates only what the mode's kernels write: nothing for
    the fused bf16 design (q, k, v and the context stay on the SM), q, k, v
    as bf16 for a band too wide for its registers (the MHSA kernel's
    design), qkv and the context in f32 for the all-f32 one. On the CPU
    nothing is launched and no design is recorded."""
    got = banded_scratch(777, precise, in_registers)
    if precise:
        assert got == [("qkv", (777, 192), torch.float32),
                       ("ctx", (777, 64), torch.float32)]
    elif in_registers:
        assert got == []
    else:
        assert got == [("qkv", (777, 192), torch.bfloat16)]
    design, launches = banded_mhsa.design, banded_mhsa.launches
    x, _ = _inputs(1, 20, False)
    banded_mhsa(torch.from_numpy(x), *map(torch.from_numpy, _params()),
                lookback=64, precise=precise)
    assert (banded_mhsa.design, banded_mhsa.launches) == (design, launches)


def _c_entry_points(source):
    """{name: parameter count} of the extern "C" functions of csrc/<source>."""
    with open(os.path.join(_build.CSRC_DIR, source), encoding="utf-8") as f:
        src = f.read()
    return {name: len([a for a in args.split(",") if a.strip()])
            for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         src)}


@pytest.mark.parametrize("precise", [False, True])
def test_kernel_entry_point_per_mode(precise):
    """Each mode launches its own C entry point of csrc/banded.cu (as
    csrc/mhsa.cu is split), declared with as many argtypes as the function
    has parameters (ctypes does not check them)."""
    name, argtypes = BANDED_ENTRY[precise]
    assert name == ("lct_banded_forward_f32" if precise
                    else "lct_banded_forward_bf16")
    entries = _c_entry_points("banded.cu")
    assert entries[name] == len(argtypes)
    assert entries["lct_banded_max_register_lookback"] == 0

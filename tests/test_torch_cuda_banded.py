"""The banded-attention CUDA kernels (lct_gan_tpu_torch/csrc/banded.cu) on the
card against their plain PyTorch version on the same inputs, at edge shapes
the serving path does not reach: W = 0 and 1; W on both sides of the widest
band whose scores the bf16 kernel keeps in registers (112 keys back; wider
bands take the MHSA kernel's tensor-core design, and the precise kernel
stages the keys in several chunks); S below one work item and not a
multiple of it; one long sequence; ragged tails; rows whose whole band is
key-masked. Also the design each mode runs, bit-equal bf16 reruns, the
agreement with the MHSA kernel under the same band, and the module's
routing on the card.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_banded.py

Tolerances are chip_smoke.py's: precise (all f32) 1e-3, sum order only;
bf16 3e-2, where a different f32 sum order can move a rounded operand by one
bf16 ulp.
"""

import pytest
import torch

from lct_gan_tpu_torch.models.attention import MultiHeadSelfAttention
from lct_gan_tpu_torch.ops.attention import fused_mhsa
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)

pytestmark = pytest.mark.cuda

TOL = {True: 1e-3, False: 3e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, S, kb_mode, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, S, 64), generator=g)
    params = [0.25 * (2 * torch.rand(s, generator=g) - 1)
              for s in ((64, 192), (192,), (64, 64), (64,))]
    kb = None
    if kb_mode == "tail":
        valid = torch.randint(max(1, S // 3), S + 1, (N,), generator=g)
        kb = torch.where(torch.arange(S)[None, :] < valid[:, None], 0.0,
                         -1e30)
    elif kb_mode == "rows":  # row 0's every key masked
        kb = torch.zeros((N, S))
        kb[0] = -1e30
    return x, params, kb


def _cuda(*ts):
    return [None if t is None else t.cuda() for t in ts]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("N,S,W,kb_mode", [
    (3, 1, 64, None),       # one key, one query
    (2, 77, 0, "tail"),     # W = 0: the self key alone
    (2, 200, 1, "tail"),
    (3, 300, 64, "tail"),   # the serving band, ragged last tile
    (2, 333, 64, "rows"),   # whole band key-masked: uniform, finite
    (2, 129, 128, None),    # W = tile: keys fit one stage exactly
    (1, 600, 130, "tail"),  # W > 128: keys staged in two chunks
    (1, 1000, 2000, "tail"),  # W > S: every earlier key, several chunks
])
def test_banded_kernel_matches_plain(card, N, S, W, kb_mode, precise):
    x, params, kb = _inputs(N, S, kb_mode, seed=S + W)
    x, kb, *params = _cuda(x, kb, *params)
    kw = dict(num_heads=4, lookback=W, key_bias=kb, precise=precise)
    before = banded_mhsa.launches
    out = banded_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    assert banded_mhsa.launches == before + 1
    ref = banded_mhsa_reference(x, *params, **kw)
    assert out.shape == (N, S, 64) and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= TOL[precise], err


@pytest.mark.parametrize("precise", [True, False])
def test_banded_kernel_agrees_with_mhsa_kernel(card, precise):
    x, params, kb = _inputs(4, 300, "tail", seed=7)
    x, kb, *params = _cuda(x, kb, *params)
    kw = dict(num_heads=4, lookback=64, key_bias=kb, precise=precise)
    a = banded_mhsa(x, *params, **kw)
    b = fused_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= TOL[precise]


def test_module_routes_the_band_to_the_banded_kernel(card):
    torch.manual_seed(0)
    attn = MultiHeadSelfAttention(64, 4).cuda()
    x = torch.randn(2, 800, 64, device="cuda")
    b0, m0 = banded_mhsa.launches, fused_mhsa.launches
    with torch.no_grad():
        attn(x, lookback=64)
        attn(x[:, :700], lookback=64)
    assert (banded_mhsa.launches - b0, fused_mhsa.launches - m0) == (1, 1)


def test_banded_kernel_rejects_other_widths(card):
    """200 channels in 5 heads of 40 (widened to 64: 320 channels) pass the
    widest kernel, 256 channels; refused before any launch."""
    x = torch.zeros((1, 10, 200), device="cuda")
    p = [torch.zeros(s, device="cuda") for s in ((200, 600), (600,),
                                                  (200, 200), (200,))]
    before = banded_mhsa.launches
    with pytest.raises(ValueError, match="got E=200, num_heads 5.*needs 320"):
        banded_mhsa(x, *p, num_heads=5, lookback=4)
    assert banded_mhsa.launches == before


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("N,S,W,kb_mode", [
    (2, 40, 64, "tail"),    # S below one work item
    (2, 777, 64, "tail"),   # S not a multiple of the item's rows
    (2, 400, 16, None),     # one chunk of halo
    (2, 500, 112, "tail"),  # the widest band kept in registers
    (2, 500, 113, "tail"),  # one key wider: the MHSA kernel's design
    (1, 2500, 200, "tail"),  # the MHSA kernel's design past its L <= 1024
    (1, 5000, 64, "tail"),  # one long sequence
])
def test_banded_kernel_matches_plain_new_shapes(card, N, S, W, kb_mode,
                                                precise):
    x, params, kb = _inputs(N, S, kb_mode, seed=S + W)
    x, kb, *params = _cuda(x, kb, *params)
    kw = dict(num_heads=4, lookback=W, key_bias=kb, precise=precise)
    out = banded_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    ref = banded_mhsa_reference(x, *params, **kw)
    assert out.shape == (N, S, 64) and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= TOL[precise], err


@pytest.mark.parametrize("precise", [True, False])
def test_banded_kernel_records_its_design(card, precise):
    x, params, kb = _inputs(2, 300, "tail", seed=3)
    x, kb, *params = _cuda(x, kb, *params)
    banded_mhsa(x, *params, lookback=64, key_bias=kb, precise=precise)
    assert banded_mhsa.design == ("simt-f32" if precise else "tc-bf16")


@pytest.mark.parametrize("W", [64, 200])
def test_bf16_launches_are_bit_equal(card, W):
    x, params, kb = _inputs(3, 1111, "tail", seed=W)
    x, kb, *params = _cuda(x, kb, *params)
    kw = dict(num_heads=4, lookback=W, key_bias=kb, precise=False)
    a = banded_mhsa(x, *params, **kw)
    b = banded_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("S", [300, 900])
def test_bf16_design_agrees_with_mhsa_kernel(card, S):
    x, params, kb = _inputs(3, S, "tail", seed=S)
    x, kb, *params = _cuda(x, kb, *params)
    kw = dict(num_heads=4, lookback=64, key_bias=kb, precise=False)
    a = banded_mhsa(x, *params, **kw)
    b = fused_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= TOL[False]


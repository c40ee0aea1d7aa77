"""The four forward kernels at kernel width 512 (csrc/ftf.cu, mhsa.cu and
banded.cu built with -DLCT_C=512; the layouts padded to 512 by the
wrappers) on the card against their plain PyTorch versions on the same
inputs, at the edges of their shapes: one sequence, one step, the longest
fused length, a ragged sequence count (the step GRU takes 64 sequences a
block, the cluster GRU 4 a cluster, the epilogue 64 rows a tile, a head of
512 48 query rows an item), bands of 0 and past a key tile, and the routes
of that width: GRU slots of 16 (half the slots a block), of 64 (groups of
32 packed two to a slot, and of 64; four slots a block), of 128 (a slot a
block), of 256 (two thread-block clusters) and one of 512 (a launch a step
over all sequences), head widths 4 .. 512 (heads of <= 8 masked in their
16-channel k-step, a head of 512 in four context parts of 128 channels,
heads of 128 to 512 a warp a query in precise mode), and C = 272, 300 and
320 padded to 512. The FTF backward is not built at 512.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_width512.py

Inputs: tests/test_torch_cuda_width256.py's, the weight matrices scaled
by sqrt(64 / C), a fan-in init's scale. Tolerances as theirs: max |diff|
3e-2 bf16, 1e-3 precise, 1e-5 the composed GRU (all f32); the FTF block in
bf16 may instead show that it is as accurate as its plain version against
the f32 plain version (a rounding flip in a hidden state moves the rest of
its sequence).
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, fused_ftf_block
from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain
from lct_gan_tpu_torch.ops.padding import kernel_width

from test_torch_cuda_channels import _close, _ftf_params, _tail, _u
from test_torch_cuda_width256 import TOL, TOL_GRU, _attn_params, _fan_in

pytestmark = pytest.mark.cuda

# (C, heads, groups): every GRU slot kind and head width of kernel width
# 512, and layouts padded to it.
ROUTES = [(512, 1, 1), (512, 2, 2), (512, 4, 4), (512, 8, 8), (512, 1, 32),
          (512, 16, 16), (512, 64, 64), (512, 128, 16), (272, 1, 1),
          (300, 3, 3), (320, 5, 5)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True, widths=(512,))
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(kernel_width(C, nh, G) == 512 for C, nh, G in ROUTES)
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (5, 17), (3, 512)])
@pytest.mark.parametrize("kind", ["freq", "time_key_bias", "time_lookback"])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_ftf_block_at_512(card, C, nh, G, kind, N, L, mode):
    g = torch.Generator().manual_seed(C * 1000 + nh * 10 + G + L)
    D = 2 if kind == "freq" else 1
    x = torch.randn((N, L, C), generator=g).cuda()
    params = _fan_in(_ftf_params(g, C, G, D), C)
    kb = _tail(g, N, L).cuda() if kind == "time_key_bias" else None
    kw = dict(bidirectional=D == 2, num_heads=nh,
              lookback=3 if kind == "time_lookback" else None,
              precise=mode == "precise")
    before = fused_ftf_block.launches
    got = fused_ftf_block(x, *params, key_bias=kb, **kw)
    torch.cuda.synchronize()
    assert fused_ftf_block.launches == before + 1
    want = ftf_block_reference(x, *params, key_bias=kb, **kw)
    what = f"FTF C={C} heads={nh} groups={G} {kind} N={N} L={L}"
    if mode == "bf16" and (got - want).abs().max().item() > TOL[mode]:
        ref32 = ftf_block_reference(x, *params, key_bias=kb,
                                    **dict(kw, precise=True))
        dk, dp = (got - ref32).abs(), (want - ref32).abs()
        assert torch.isfinite(got).all(), what
        assert dk.max() <= 2 * dp.max() and dk.mean() <= 2 * dp.mean(), (
            f"{what}: |kernel - f32| max {dk.max().item()} mean "
            f"{dk.mean().item()} against the plain version's "
            f"{dp.max().item()} / {dp.mean().item()}")
        return
    _close(got, want, mode, what)


@pytest.mark.parametrize("N,L,D", [(1, 1, 1), (3, 513, 1), (1, 520, 2),
                                   (67, 600, 1)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_grouped_gru_at_512(card, C, nh, G, N, L, D):
    g = torch.Generator().manual_seed(C + G + L)
    x = torch.randn((N, L, C), generator=g).cuda()
    params = _fan_in(_ftf_params(g, C, G, D)[:6], C)
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(x, *params, bidirectional=D == 2)
    torch.cuda.synchronize()
    assert fused_grouped_gru.launches == before + 1
    want = grouped_gru_plain(x, *params, D == 2)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= TOL_GRU, (
        f"GRU C={C} groups={G} N={N} L={L} D={D}: max|diff| {err}")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (2, 1024), (9, 70)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_mhsa_at_512(card, C, nh, G, N, L, mode):
    g = torch.Generator().manual_seed(C + nh + L)
    x = torch.randn((N, L, C), generator=g).cuda()
    p = _attn_params(g, C)
    kb = _tail(g, N, L).cuda()
    kw = dict(num_heads=nh, key_bias=kb, precise=mode == "precise")
    got = fused_mhsa(x, *p, **kw)
    torch.cuda.synchronize()
    _close(got, mhsa_reference(x, *p, **kw), mode,
           f"MHSA C={C} heads={nh} N={N} L={L}")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("S,W", [(1, 0), (40, 0), (300, 64), (500, 200)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_banded_at_512(card, C, nh, G, S, W, mode):
    g = torch.Generator().manual_seed(C + nh + S)
    x = torch.randn((3, S, C), generator=g).cuda()
    p = _attn_params(g, C)
    kb = _tail(g, 3, S).cuda()
    kw = dict(num_heads=nh, lookback=W, key_bias=kb,
              precise=mode == "precise")
    got = banded_mhsa(x, *p, **kw)
    torch.cuda.synchronize()
    _close(got, banded_mhsa_reference(x, *p, **kw), mode,
           f"banded C={C} heads={nh} S={S} W={W}")


@pytest.mark.parametrize("kernel", ["mhsa", "banded"])
@pytest.mark.parametrize("C,nh,G", [(512, 1, 1), (512, 4, 4), (320, 5, 5)])
def test_bf16_attention_at_unscaled_weights(card, C, nh, G, kernel):
    """At unscaled weights, where the outputs at 512 are several times as
    large, the bf16 kernel is as close to the f32 plain version as the
    bf16 plain version is (max and mean |diff| within 2x of the plain
    version's)."""
    g = torch.Generator().manual_seed(C + nh + G + 512)
    if kernel == "mhsa":
        N, L, fn, ref, extra = 9, 70, fused_mhsa, mhsa_reference, {}
    else:
        N, L, fn, ref = 3, 500, banded_mhsa, banded_mhsa_reference
        extra = {"lookback": 200}
    x = torch.randn((N, L, C), generator=g).cuda()
    p = [t.cuda() for t in (_u(g, C, 3 * C), 0.1 * _u(g, 3 * C),
                            _u(g, C, C), 0.1 * _u(g, C))]
    kw = dict(num_heads=nh, key_bias=_tail(g, N, L).cuda(), **extra)
    got = fn(x, *p, precise=False, **kw)
    torch.cuda.synchronize()
    ref32 = ref(x, *p, precise=True, **kw)
    dk = (got - ref32).abs()
    dp = (ref(x, *p, precise=False, **kw) - ref32).abs()
    what = f"{kernel} C={C} heads={nh} unscaled"
    assert torch.isfinite(got).all(), what
    assert dk.max() <= 2 * dp.max() and dk.mean() <= 2 * dp.mean(), (
        f"{what}: |kernel - f32| max {dk.max().item()} mean "
        f"{dk.mean().item()} against the plain version's "
        f"{dp.max().item()} / {dp.mean().item()}")

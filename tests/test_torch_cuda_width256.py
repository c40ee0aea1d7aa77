"""The four forward kernels and the FTF backward at kernel width 256
(csrc/ftf.cu, mhsa.cu, banded.cu, ftf_bwd.cu built with -DLCT_C=256; the
layouts padded to 256 by the wrappers) on the card against their plain
PyTorch versions on the same inputs, at the edges of their shapes: one sequence, one step, the longest
fused length, a ragged sequence count (the cluster GRU takes 4 sequences a
cluster, the epilogue 128 rows a tile), bands of 0 and past a key tile,
and the routes of that width: GRU slots of 16, of 64 (groups of 32 packed
two to a slot, and of 64), of 128 (a slot a block) and one of 256 (the
thread-block cluster), head widths 4 .. 256 (heads of <= 8 masked in
their 16-channel k-step, heads of 128 and 256 a warp a query in precise
mode), and C = 100, 144 and 200 padded to 256. The backward at every
(heads, groups) pair of its routes (BACKWARD_ROUTES: GRU slots of 16, 64,
128 and the cluster's 256, heads of 4 .. 256) and at C = 100, 120 and 144
padded to 256, bands none, 0 and 5.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_width256.py

Inputs: tests/test_torch_cuda_channels.py's, the weight matrices scaled
by sqrt(64 / C), a fan-in init's scale, so that the activations are as
large as at C = 64. Unscaled, the outputs at C = 256 grow to 2-3x C =
128's, and one bf16 rounding flip of that size passes the absolute
tolerance, while the kernel stays exactly as far from the f32 version as
the plain bf16 version does: test_bf16_attention_at_unscaled_weights
holds the attention kernels to that at the unscaled weights.

Tolerances as tests/test_torch_cuda_channels.py's: max |diff| 3e-2 bf16,
1e-3 precise, 1e-5 the composed GRU (all f32); the FTF block in bf16 may
instead show that it is as accurate as its plain version against the f32
plain version (a rounding flip in a hidden state moves the rest of its
sequence).
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference, fused_ftf_block,
                                       ftf_forward_with_hidden)
from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_plain, fused_ftf_bwd
from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain
from lct_gan_tpu_torch.ops.padding import kernel_width

from test_torch_cuda_channels import TOL, _close, _ftf_params, _tail, _u

pytestmark = pytest.mark.cuda

TOL_GRU = 1e-5
# (C, heads, groups): every GRU slot kind and head width of kernel width
# 256, and layouts padded to it.
ROUTES = [(256, 1, 1), (256, 4, 4), (256, 2, 8), (256, 16, 16),
          (256, 8, 2), (256, 64, 64), (100, 5, 5), (144, 4, 4),
          (200, 8, 8)]
# (C, heads, groups) of the backward: chip_smoke.py's W256_PAIRS at C = 256
# and its W256_PADDED layouts.
BACKWARD_ROUTES = [(256, 1, 16), (256, 2, 8), (256, 4, 4), (256, 8, 2),
                   (256, 16, 1), (256, 32, 32), (256, 64, 64), (100, 5, 5),
                   (120, 3, 3), (144, 4, 4)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True, widths=(256,), backward=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(kernel_width(C, nh, G) == 256
               for C, nh, G in ROUTES + BACKWARD_ROUTES)
    return torch.device("cuda")


def _fan_in(params, C):
    """params on the card, the weight matrices scaled by sqrt(64 / C)."""
    f = (64.0 / C) ** 0.5
    return [(p * f if p.dim() >= 2 else p).cuda() for p in params]


def _attn_params(g, C):
    return _fan_in((_u(g, C, 3 * C), 0.1 * _u(g, 3 * C), _u(g, C, C),
                    0.1 * _u(g, C)), C)


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (5, 17), (3, 512)])
@pytest.mark.parametrize("kind", ["freq", "time_key_bias", "time_lookback"])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_ftf_block_at_256(card, C, nh, G, kind, N, L, mode):
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
                                   (7, 600, 1)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_grouped_gru_at_256(card, C, nh, G, N, L, D):
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
def test_mhsa_at_256(card, C, nh, G, N, L, mode):
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
def test_banded_at_256(card, C, nh, G, S, W, mode):
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
@pytest.mark.parametrize("C,nh,G", [(256, 1, 1), (256, 4, 4), (200, 8, 8)])
def test_bf16_attention_at_unscaled_weights(card, C, nh, G, kernel):
    """At tests/test_torch_cuda_channels.py's unscaled weights, where the
    outputs at 256 are 2-3x as large, the bf16 kernel is as close to the
    f32 plain version as the bf16 plain version is (max and mean |diff|
    within 2x of the plain version's)."""
    g = torch.Generator().manual_seed(C + nh + G + 256)
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


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (4, 33), (9, 129)])
@pytest.mark.parametrize("kind", ["freq", "time_band0", "time_band5"])
@pytest.mark.parametrize("C,nh,G", BACKWARD_ROUTES)
def test_ftf_backward_at_256(card, C, nh, G, kind, N, L, mode):
    """fused_ftf_bwd against ftf_bwd_plain on the card: every gradient
    within TOL of its largest magnitude, or in bf16 as close to the f32
    plain version as the bf16 plain version is (the C = 128 backward
    cases' test, tests/test_torch_cuda_channels.py)."""
    g = torch.Generator().manual_seed(C * 1000 + nh * 10 + G + L + 7)
    D = 2 if kind == "freq" else 1
    x = torch.randn((N, L, C), generator=g).cuda()
    params = _fan_in(_ftf_params(g, C, G, D), C)
    lookback = {"freq": None, "time_band0": 0, "time_band5": 5}[kind]
    precise = mode == "precise"
    out, hid = ftf_forward_with_hidden(x, *params, bidirectional=D == 2,
                                       num_heads=nh, lookback=lookback,
                                       precise=precise)
    act = out - x - hid.sum(dim=0).reshape(N, L, C)
    comb = torch.where(act >= 0, act, act / 0.2)
    dout = torch.randn((N, L, C), generator=g).cuda()
    dout = torch.where(comb.abs() < (1e-3 if precise else 5e-2), 0.0, dout)
    args = (x, *params, hid, dout, D == 2, nh, lookback)
    before = fused_ftf_bwd.launches
    got = fused_ftf_bwd(*args[:17], bidirectional=D == 2, num_heads=nh,
                        lookback=lookback, precise=precise)
    torch.cuda.synchronize()
    assert fused_ftf_bwd.launches == before + 1
    want = ftf_bwd_plain(*args, precise)
    ref32 = ftf_bwd_plain(*args, True) if not precise else want
    what = f"FTF backward C={C} heads={nh} groups={G} {kind} N={N} L={L}"
    for i, (a, b, r) in enumerate(zip(got, want, ref32)):
        assert a.shape == b.shape and torch.isfinite(a).all(), (what, i)
        scale = max(b.abs().max().item(), 1e-30)
        if (a - b).abs().max().item() <= TOL[mode] * scale:
            continue
        assert not precise, (what, i, (a - b).abs().max().item() / scale)
        dk, dp = (a - r).abs(), (b - r).abs()
        assert dk.max() <= 2 * dp.max() and dk.mean() <= 2 * dp.mean(), (
            f"{what} gradient {i}: |kernel - f32| max {dk.max().item()} "
            f"mean {dk.mean().item()} against the plain version's "
            f"{dp.max().item()} / {dp.mean().item()}")

"""The four forward kernels and the FTF backward at bottleneck widths other
than 64 (csrc/ftf.cu, mhsa.cu, banded.cu, ftf_bwd.cu built per kernel
width, -DLCT_C; other widths zero-padded by the wrappers to the kernel
width of their layout: 48 and 40 to 64, 96, 50 and 80 to 128, 24 to 32, 8
to 16) on the card against their plain PyTorch versions on the same inputs,
at the edges of their shapes: one sequence,
one step, the longest fused length, a ragged sequence count (the f32 GRU's
warps hang over the end at C = 16), bands of 0 and past the fused banded
kernel's reach, and the widths where the routes change (a dense GRU slot
of C at C <= 64, of 64 on tensor cores and of 128 on CUDA cores at C =
128; heads padded to a power of two; heads and groups past num_heads and
gru_groups, where the layout passes the next power of two above C).

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_channels.py

Tolerances as `chip_smoke.py`'s: max |diff| 3e-2 bf16 (both round the same
operands; f32 sum order moves a value across a bf16 boundary now and then),
1e-3 precise (all f32: sum order and the last ulp of exp / tanh / rsqrt).
The FTF block in bf16 may instead show that it is as accurate as its plain
version: against the f32 plain version, its max and mean |diff| within
twice the bf16 plain version's own. Along a 512-step recurrence over GRU
groups of 64-128 units one such flip in a hidden state moves the rest of
the sequence: at C = 96 and 128 the kernel and the plain version end up
0.02-0.10 apart (max; mean 4e-5 .. 5e-3) while each is 0.04-0.14 (max;
mean 0.005-0.011) from f32, and precise mode agrees to 1.5e-5 (my chip
runs, NVIDIA H100 80GB HBM3, 700.00 W). A wiring fault is O(1) from f32.
The backward's 15 gradients are held as chip_smoke.py holds them, each
relative to its largest magnitude, the cotangent zeroed near the
LeakyReLU's kink; in bf16 a gradient past the band may instead show that
it is as accurate as the plain version's, against the f32 plain backward.
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

pytestmark = pytest.mark.cuda

TOL = {"bf16": 3e-2, "precise": 1e-3}
WIDTHS = (16, 32, 64, 128)    # the kernel widths (ops/library.py)
# (C, heads, groups): the routes each width takes.
ROUTES = [(16, 2, 1), (16, 16, 16), (32, 1, 1), (48, 3, 16), (48, 16, 2),
          (96, 6, 4), (96, 32, 1), (128, 1, 2), (128, 8, 128),
          (8, 2, 2), (24, 3, 3), (40, 4, 4), (50, 5, 5), (80, 4, 4)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True, widths=WIDTHS, backward=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _u(g, *shape, b=0.25):
    return b * (2 * torch.rand(shape, generator=g) - 1)


def _ftf_params(g, C, G, D):
    H = C // G
    return [1 + 0.1 * _u(g, C), 0.1 * _u(g, C), _u(g, D, G, H, 3 * H),
            _u(g, D, G, H, 3 * H), _u(g, D, G, 3 * H), _u(g, D, G, 3 * H),
            1 + 0.1 * _u(g, C), 0.1 * _u(g, C), _u(g, C, 3 * C),
            0.1 * _u(g, 3 * C), _u(g, C, C), 0.1 * _u(g, C),
            _u(g, D * C, C), 0.1 * _u(g, C)]


def _tail(g, N, L):
    valid = torch.randint(1, L + 1, (N,), generator=g)
    return torch.where(torch.arange(L)[None, :] < valid[:, None], 0.0, -1e30)


def _close(got, want, mode, what):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all(), what
    assert err <= TOL[mode], f"{what}: max|diff| {err} > {TOL[mode]}"


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (5, 17), (3, 512)])
@pytest.mark.parametrize("kind", ["freq", "time_key_bias", "time_lookback"])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_ftf_block_at_every_route(card, C, nh, G, kind, N, L, mode):
    g = torch.Generator().manual_seed(C * 1000 + nh * 10 + G + L)
    D = 2 if kind == "freq" else 1
    x = torch.randn((N, L, C), generator=g).cuda()
    params = [p.cuda() for p in _ftf_params(g, C, G, D)]
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


@pytest.mark.parametrize("N,L,D", [(3, 513, 1), (1, 520, 2), (7, 600, 1)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_grouped_gru_at_every_route(card, C, nh, G, N, L, D):
    g = torch.Generator().manual_seed(C + G + L)
    x = torch.randn((N, L, C), generator=g).cuda()
    params = [p.cuda() for p in _ftf_params(g, C, G, D)[:6]]
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(x, *params, bidirectional=D == 2)
    torch.cuda.synchronize()
    assert fused_grouped_gru.launches == before + 1
    _close(got, grouped_gru_plain(x, *params, D == 2), "precise",
           f"GRU C={C} groups={G} N={N} L={L} D={D}")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (2, 1024), (9, 70)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_mhsa_at_every_route(card, C, nh, G, N, L, mode):
    g = torch.Generator().manual_seed(C + nh + L)
    x = torch.randn((N, L, C), generator=g).cuda()
    p = [a.cuda() for a in (_u(g, C, 3 * C), 0.1 * _u(g, 3 * C),
                            _u(g, C, C), 0.1 * _u(g, C))]
    kb = _tail(g, N, L).cuda()
    kw = dict(num_heads=nh, key_bias=kb, precise=mode == "precise")
    got = fused_mhsa(x, *p, **kw)
    torch.cuda.synchronize()
    _close(got, mhsa_reference(x, *p, **kw), mode,
           f"MHSA C={C} heads={nh} N={N} L={L}")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("S,W", [(40, 0), (300, 64), (500, 200)])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_banded_at_every_route(card, C, nh, G, S, W, mode):
    g = torch.Generator().manual_seed(C + nh + S)
    x = torch.randn((3, S, C), generator=g).cuda()
    p = [a.cuda() for a in (_u(g, C, 3 * C), 0.1 * _u(g, 3 * C),
                            _u(g, C, C), 0.1 * _u(g, C))]
    kb = _tail(g, 3, S).cuda()
    kw = dict(num_heads=nh, lookback=W, key_bias=kb,
              precise=mode == "precise")
    got = banded_mhsa(x, *p, **kw)
    torch.cuda.synchronize()
    _close(got, banded_mhsa_reference(x, *p, **kw), mode,
           f"banded C={C} heads={nh} S={S} W={W}")


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (5, 17), (2, 512)])
@pytest.mark.parametrize("kind", ["freq", "time_lookback"])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_ftf_backward_at_every_route(card, C, nh, G, kind, N, L, mode):
    g = torch.Generator().manual_seed(C * 1000 + nh * 10 + G + L + 7)
    D = 2 if kind == "freq" else 1
    x = torch.randn((N, L, C), generator=g).cuda()
    params = [p.cuda() for p in _ftf_params(g, C, G, D)]
    lookback = 3 if kind == "time_lookback" else None
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

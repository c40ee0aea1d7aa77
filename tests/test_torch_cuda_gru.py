"""The composed time block's LN1 + grouped GRU kernel (csrc/ftf.cu,
`lct_grouped_gru_f32` / `gru_f32_kernel`, through
`ops/gru.py::fused_grouped_gru`) on the card against its plain PyTorch
version on the same inputs: L = 513 (the shortest composed length), 516 and
644 (the 131,072- and 163,840-sample buckets), 1,030 and 3,588 (the 262,144-
and 917,504-sample buckets); one and two directions. Then the design's
edges: L = 1, L one below and one above a multiple of the chunk (16 steps;
4 for a slot of 128), a block per sequence with N = 1 and odd N, and every
slot kind: 16, one dense 64 (1 and 2 groups), two of 64 and one of 128 at C
= 128, one of 32 at C = 32, C = 16, and C = 48 through the padding. One
launch per call; under grad, the gradients are the plain version's.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_gru.py

Tolerance 1e-5 max abs: both sides are all f32, so only the order of the
f32 sums and a few ulps of the kernel's exp / reciprocal gates differ; the
GRU's gates keep those differences from growing along the sequence.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.library import KERNEL_WIDTHS

    build_all(verbose=True, widths=KERNEL_WIDTHS)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, L, D, seed, C=64, G=4):
    g = torch.Generator().manual_seed(seed)

    def u(*s, b=0.25):
        return b * (2 * torch.rand(s, generator=g) - 1)

    H = C // G
    x = torch.randn((N, L, C), generator=g)
    params = [1 + 0.1 * u(C), 0.1 * u(C), u(D, G, H, 3 * H),
              u(D, G, H, 3 * H), u(D, G, 3 * H), u(D, G, 3 * H)]
    return x.cuda(), [p.cuda() for p in params]


def _check(N, L, D, seed, C=64, G=4):
    x, p = _inputs(N, L, D, seed, C, G)
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(x, *p, bidirectional=D == 2)
    torch.cuda.synchronize()
    assert fused_grouped_gru.launches == before + 1
    want = grouped_gru_plain(x, *p, D == 2)
    assert got.shape == (N, L, C) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    print(f"fused_grouped_gru N={N} L={L} D={D} C={C} G={G}: "
          f"max|diff| {err:.3e}")
    assert err <= TOL


CASES = [
    # N, L, D
    (7, 513, 1),
    (37, 516, 1),
    (33, 644, 1),
    (5, 644, 2),
    (3, 1030, 1),
    (3, 1030, 2),
    (2, 3588, 1),
    (1, 3588, 2),
]


@pytest.mark.parametrize("N,L,D", CASES)
def test_gru_kernel_matches_plain(card, N, L, D):
    _check(N, L, D, seed=N * L + D)


EDGES = [
    # N, L, D, C, G: the chunk's edges (16 steps), then each slot kind
    (3, 1, 1, 64, 4),
    (3, 1, 2, 64, 4),
    (5, 7, 1, 64, 4),
    (5, 9, 2, 64, 4),
    (1, 15, 1, 64, 4),
    (7, 17, 2, 64, 4),
    (2, 16, 1, 64, 4),
    (2, 31, 2, 64, 4),
    (2, 33, 1, 64, 4),
    (3, 40, 1, 64, 1),      # one dense slot of 64
    (3, 41, 2, 64, 2),      # two groups packed into one of 64
    (3, 23, 1, 128, 4),     # two slots of 64
    (2, 25, 2, 128, 2),
    (2, 3, 1, 128, 1),      # one slot of 128 (4-step chunks)
    (2, 5, 2, 128, 1),
    (3, 9, 1, 128, 8),      # slots of 16 at 128
    (3, 33, 2, 32, 1),      # one dense slot of 32
    (3, 31, 1, 32, 4),      # groups of 8 packed into slots of 16
    (4, 19, 2, 16, 1),
    (4, 21, 1, 16, 16),
    (3, 27, 2, 48, 3),      # padded: groups of 16 at 64
    (3, 26, 1, 48, 1),      # padded: one of 48 in a slot of 64
    (2, 11, 1, 96, 2),      # padded: slots of 64 at 128
    (2, 13, 2, 96, 1),      # padded: one of 96 in a slot of 128
    (11, 600, 1, 128, 1),
    (9, 520, 2, 64, 1),
]


@pytest.mark.parametrize("N,L,D,C,G", EDGES)
def test_gru_kernel_edges_match_plain(card, N, L, D, C, G):
    _check(N, L, D, seed=1000 + N * L + C + G + D, C=C, G=G)


@pytest.mark.parametrize("D", [1, 2])
def test_gradients_on_the_card_are_the_plain_versions(card, D):
    x, p = _inputs(3, 520, D, seed=90 + D)
    dout = torch.randn((3, 520, 64), generator=torch.Generator().manual_seed(
        91)).cuda()
    leaves = [t.clone().requires_grad_() for t in (x, *p)]
    got = torch.autograd.grad(
        fused_grouped_gru(*leaves, bidirectional=D == 2), leaves, dout)
    plain = [t.clone().requires_grad_() for t in (x, *p)]
    want = torch.autograd.grad(grouped_gru_plain(*plain, D == 2), plain, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrong_width_raises_on_the_card(card):
    """288 channels (2 groups of 144, widened to 256 each) pass the widest
    kernel, 256 channels; refused before any launch."""
    x = torch.zeros((2, 600, 288), device="cuda")
    p = [torch.zeros(s, device="cuda") for s in
         ((288,), (288,), (1, 2, 144, 432), (1, 2, 144, 432), (1, 2, 432),
          (1, 2, 432))]
    before = fused_grouped_gru.launches
    with pytest.raises(ValueError,
                       match="fits 256 channels, got C=288.*needs 512"):
        fused_grouped_gru(x, *p, bidirectional=False)
    assert fused_grouped_gru.launches == before

"""The composed time block's LN1 + grouped GRU kernels (csrc/ftf.cu,
`lct_grouped_gru_f32`, through `ops/gru.py::fused_grouped_gru`) on the card
against their plain PyTorch version on the same inputs: L = 513 (the
shortest composed length), 516 and 644 (the 131,072- and 163,840-sample
buckets), 1,030 and 3,588 (the 262,144- and 917,504-sample buckets); one
and two directions; sequence counts that are not a multiple of the
recurrence kernel's 256-thread block (4 sequences a block with one
direction, 2 with two). One launch per call; under grad, the gradients are
the plain version's.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_gru.py

Tolerance 1e-4 max abs: both sides are all f32, so only the order of the
f32 sums and the last ulp of exp / tanh / rsqrt differ; the GRU's gates keep
those differences from growing along the sequence.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, L, D, seed):
    g = torch.Generator().manual_seed(seed)

    def u(*s, b=0.25):
        return b * (2 * torch.rand(s, generator=g) - 1)

    x = torch.randn((N, L, 64), generator=g)
    params = [1 + 0.1 * u(64), 0.1 * u(64), u(D, 4, 16, 48), u(D, 4, 16, 48),
              u(D, 4, 48), u(D, 4, 48)]
    return x.cuda(), [p.cuda() for p in params]


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
    x, p = _inputs(N, L, D, seed=N * L + D)
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(x, *p, bidirectional=D == 2)
    torch.cuda.synchronize()
    assert fused_grouped_gru.launches == before + 1
    want = grouped_gru_plain(x, *p, D == 2)
    assert got.shape == (N, L, 64) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    print(f"fused_grouped_gru N={N} L={L} D={D}: max|diff| {err:.3e}")
    assert err <= TOL


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
    """40 channels (2 groups of 20) lie outside the kernels' channel set."""
    x = torch.zeros((2, 600, 40), device="cuda")
    p = [torch.zeros(s, device="cuda") for s in
         ((40,), (40,), (1, 2, 20, 60), (1, 2, 20, 60), (1, 2, 60),
          (1, 2, 60))]
    with pytest.raises(ValueError, match="takes C in .*got C=40"):
        fused_grouped_gru(x, *p, bidirectional=False)

"""The FTF-block backward CUDA kernel (lct_gan_tpu_torch/csrc/ftf_bwd.cu) on
the card against its plain PyTorch version on the same inputs, at edge
shapes the training path does not reach: N = 1, L = 1, lookback = 0, row
counts that are not a multiple of any block size; plus determinism, the
save-hidden forward, and autograd through the block on the card.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_ftf_bwd.py

Tolerances are chip_smoke.py's, relative to each gradient's largest
magnitude: precise (all f32) 1e-3, sum order only; bf16 3e-2, where a
different f32 sum order can move a rounded operand by one bf16 ulp.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                       ftf_forward_with_hidden,
                                       fused_ftf_block)
from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd, ftf_bwd_reference

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


def _params(bidi, seed):
    g = torch.Generator().manual_seed(seed)
    D = 2 if bidi else 1

    def u(*s, b=0.25):
        return b * (2 * torch.rand(s, generator=g) - 1)

    return [1 + 0.1 * u(64), 0.1 * u(64), u(D, 4, 16, 48), u(D, 4, 16, 48),
            u(D, 4, 48), u(D, 4, 48), 1 + 0.1 * u(64), 0.1 * u(64),
            u(64, 192), 0.1 * u(192), u(64, 64), 0.1 * u(64),
            u(128 if bidi else 64, 64), 0.1 * u(64)], g


def _rel_errs(got, want):
    return [((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
            for a, b in zip(got, want)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("N,L,bidi,lookback", [
    (1, 1, True, None),      # one row: no recurrence, one key
    (1, 1, False, 0),
    (3, 33, True, None),     # the frequency block's length
    (37, 9, True, None),     # 333 rows: ragged in every row tiling
    (5, 129, False, None),   # the time block's length
    (5, 129, False, 0),      # band of the self key alone
    (2, 200, False, 16),
    (1, 512, False, None),   # the longest sequence the kernels take
])
def test_backward_kernel_matches_plain(card, N, L, bidi, lookback, precise):
    params, g = _params(bidi, seed=N * 1000 + L)
    x = torch.randn((N, L, 64), generator=g)
    dout = torch.randn((N, L, 64), generator=g)
    x, dout, *params = [t.cuda() for t in [x, dout] + params]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              precise=precise)
    _, hid = ftf_forward_with_hidden(x, *params, **kw)
    before = fused_ftf_bwd.launches
    got = fused_ftf_bwd(x, *params, hid, dout, **kw)
    torch.cuda.synchronize()
    assert fused_ftf_bwd.launches == before + 1
    want = ftf_bwd_reference(x, *params, hid, dout, **kw)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert all(torch.isfinite(t).all() for t in got)
    errs = _rel_errs(got, want)
    assert max(errs) <= TOL[precise], errs
    again = fused_ftf_bwd(x, *params, hid, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bidi,lookback", [(True, None), (False, 7)])
def test_autograd_on_the_card(card, bidi, lookback):
    """Under grad the forward keeps the kernel's hiddens (its output is
    bit-equal to the no-grad forward's) and the backward is the kernel."""
    params, g = _params(bidi, seed=11)
    x = torch.randn((6, 40, 64), generator=g).cuda()
    w = torch.randn((6, 40, 64), generator=g).cuda()
    params = [p.cuda() for p in params]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              precise=True)
    with torch.no_grad():
        plain_out = fused_ftf_block(x, *params, **kw)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    b0 = fused_ftf_bwd.launches
    out = fused_ftf_block(*leaves, **kw)
    assert torch.equal(out.detach(), plain_out)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    assert fused_ftf_bwd.launches == b0 + 1
    ref_leaves = [t.clone().requires_grad_() for t in [x] + params]
    ref = ftf_block_reference(*ref_leaves, **kw)
    ref_grads = torch.autograd.grad((ref * w).sum(), ref_leaves)
    errs = _rel_errs(grads, ref_grads)
    assert max(errs) <= TOL[True], errs


def test_backward_kernel_rejects_other_widths(card):
    params, _ = _params(False, seed=0)
    params = [p.cuda() for p in params]
    x = torch.zeros((1, 600, 64), device="cuda")
    hid = torch.zeros((1, 600, 64), device="cuda")
    with pytest.raises(ValueError, match="L <= 512"):
        fused_ftf_bwd(x, *params, hid, x, bidirectional=False)

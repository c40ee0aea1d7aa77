"""The FTF-block backward CUDA kernel (lct_gan_tpu_torch/csrc/ftf_bwd.cu) on
the card against its plain PyTorch version on the same inputs, at edge
shapes the training path does not reach: N = 1, L = 1, lookback = 0, row
counts that are not a multiple of any block size, at 4 heads and 4 GRU
groups and at other (heads, groups) pairs dividing 64; plus determinism,
the save-hidden forward, and autograd through the block on the card.

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
from lct_gan_tpu_torch.ops.ftf_bwd import (fused_ftf_bwd, ftf_bwd_reference,
                                           ftf_bwd_scratch_bytes)

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


def _params_widths(bidi, seed, G):
    """_params at G GRU groups of 64 / G units."""
    g = torch.Generator().manual_seed(seed)
    D, H = (2 if bidi else 1), 64 // G

    def u(*s, b=0.25):
        return b * (2 * torch.rand(s, generator=g) - 1)

    return [1 + 0.1 * u(64), 0.1 * u(64), u(D, G, H, 3 * H),
            u(D, G, H, 3 * H), u(D, G, 3 * H), u(D, G, 3 * H),
            1 + 0.1 * u(64), 0.1 * u(64), u(64, 192), 0.1 * u(192),
            u(64, 64), 0.1 * u(64), u(128 if bidi else 64, 64),
            0.1 * u(64)], g


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("nh,G", [
    (1, 1),    # one 64-channel head (the backward's split attention), one
               # dense GRU slot of 64
    (2, 2),    # heads of 32; two groups of 32 packed into one slot
    (8, 8),    # heads of 8 (masked k-steps); groups of 8 packed into 16s
    (64, 4),   # heads of 1, sixteen to a k-step
    (16, 64),  # heads of 4; groups of one unit
])
@pytest.mark.parametrize("N,L,bidi,lookback", [
    (1, 1, True, None),
    (3, 33, True, None),
    (37, 9, True, None),     # 333 rows: ragged in every row tiling
    (5, 129, False, 16),
    (1, 512, False, None),   # the longest sequence: the most shared memory
])
def test_backward_kernel_matches_plain_at_every_width(card, N, L, bidi,
                                                      lookback, nh, G,
                                                      precise):
    """Every padded head width (64, 32, 8 and 8 in rounds) and both GRU
    slot widths, against the plain version, and two launches bit-equal. In
    bf16 the cotangent is zeroed within 5e-2 of the LeakyReLU's kink, as in
    chip_smoke.py."""
    params, g = _params_widths(bidi, seed=N * 1000 + L + G, G=G)
    x = torch.randn((N, L, 64), generator=g)
    dout = torch.randn((N, L, 64), generator=g)
    x, dout, *params = [t.cuda() for t in [x, dout] + params]
    kw = dict(bidirectional=bidi, num_heads=nh, lookback=lookback,
              precise=precise)
    out, hid = ftf_forward_with_hidden(x, *params, **kw)
    if not precise:
        act = out - x - hid.sum(dim=0).reshape(N, L, 64)
        comb = torch.where(act >= 0, act, act / 0.2)
        dout = torch.where(comb.abs() < 5e-2, 0.0, dout)
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


@pytest.mark.parametrize("N,L,bidi,lookback", [
    (1037, 33, True, None),   # frequency block, rows not a multiple of 64
    (263, 129, False, 16),    # time block with a band, 263 sequences
])
def test_bf16_backward_is_deterministic_at_training_like_shapes(
        card, N, L, bidi, lookback):
    """Every output, weight gradients included, is bit-equal across two
    launches (no atomics: partial sums are added in block order) and within
    bf16 mode's tolerance of the plain version. As in chip_smoke.py, the
    cotangent is zeroed within 5e-2 of the LeakyReLU's kink, where two sum
    orders can put a pre-activation on different sides of 0."""
    params, g = _params(bidi, seed=N + L)
    x = torch.randn((N, L, 64), generator=g)
    dout = torch.randn((N, L, 64), generator=g)
    x, dout, *params = [t.cuda() for t in [x, dout] + params]
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              precise=False)
    out, hid = ftf_forward_with_hidden(x, *params, **kw)
    act = out - x - hid.sum(dim=0).reshape(N, L, 64)
    comb = torch.where(act >= 0, act, act / 0.2)
    dout = torch.where(comb.abs() < 5e-2, 0.0, dout)
    first = fused_ftf_bwd(x, *params, hid, dout, **kw)
    second = fused_ftf_bwd(x, *params, hid, dout, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want = ftf_bwd_reference(x, *params, hid, dout, **kw)
    errs = _rel_errs(first, want)
    assert max(errs) <= TOL[False], errs


@pytest.mark.parametrize("precise", [True, False])
def test_backward_records_its_design(card, precise):
    params, g = _params(True, seed=3)
    x = torch.randn((2, 33, 64), generator=g).cuda()
    params = [p.cuda() for p in params]
    kw = dict(bidirectional=True, num_heads=4, precise=precise)
    _, hid = ftf_forward_with_hidden(x, *params, **kw)
    fused_ftf_bwd(x, *params, hid, x, **kw)
    assert fused_ftf_bwd.design == ("simt-f32" if precise else "tc-bf16")


def test_bf16_scratch_is_smaller_than_f32(card):
    bf16 = ftf_bwd_scratch_bytes(1000, 33, 2, 128, precise=False)
    f32 = ftf_bwd_scratch_bytes(1000, 33, 2, 128, precise=True)
    assert 0 < bf16 < f32
    # 64 heads keep 16x the softmax statistics of 4; a dense GRU slot 4x
    # the partial sums of the GRU weight gradients.
    assert ftf_bwd_scratch_bytes(1000, 33, 2, 128, False, 64, 4) > bf16
    assert ftf_bwd_scratch_bytes(1000, 33, 2, 128, False, 4, 1) > bf16
    assert ftf_bwd_scratch_bytes(1000, 33, 2, 128, True, 64, 1) == f32


def test_backward_kernel_rejects_other_widths(card):
    params, _ = _params(False, seed=0)
    params = [p.cuda() for p in params]
    x = torch.zeros((1, 600, 64), device="cuda")
    hid = torch.zeros((1, 600, 64), device="cuda")
    with pytest.raises(ValueError, match="L <= 512"):
        fused_ftf_bwd(x, *params, hid, x, bidirectional=False)

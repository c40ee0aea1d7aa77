"""The FTF backward at kernel width 512 (csrc/ftf_bwd.cu built with
-DLCT_C=512; the layouts padded to 512 by the wrapper) on the card against
its plain PyTorch version on the same inputs, at every route of that
width: GRU slots of 16 (half a direction's slots a block), of 64, of 128,
the two of 256 that clusters of blocks walk and the one of 512 that the
step-synchronous walk takes; head widths 8 .. 512 (a head of 512 streams
its key and query blocks in 32 rows); C = 272, 300 and 320 padded to 512;
one sequence, one step, the longest block length, a sequence count past
the step walk's 64 a block, bands none, 0 and 5. Also: which GRU walk each
slot width takes (the kernels a call launches, from the profiler), and
the width-512 forward's saved hiddens, which its backward reads, against
the plain forward's.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_train_width512.py

Inputs and tolerances as tests/test_torch_cuda_width256.py's backward
cases: the weight matrices scaled by sqrt(64 / C); every gradient within
3e-2 (bf16) or 1e-3 (precise) of its largest magnitude, or in bf16 as
close to the f32 plain version as the bf16 plain version is.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                       ftf_forward_with_hidden,
                                       fused_ftf_block)
from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_plain, fused_ftf_bwd
from lct_gan_tpu_torch.ops.padding import kernel_width

from test_torch_cuda_channels import TOL, _ftf_params

pytestmark = pytest.mark.cuda

# (C, heads, groups): chip_smoke.py's W512_PAIRS at C = 512 (each slot and
# head width), 64 heads of 8 beside the slot of 512, and its W512_PADDED.
ROUTES = [(512, 1, 1), (512, 2, 2), (512, 4, 4), (512, 8, 8), (512, 1, 32),
          (512, 64, 64), (512, 64, 1), (272, 1, 1), (300, 3, 3),
          (320, 5, 5)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from lct_gan_tpu_torch.ops._build import build_all

    build_all(verbose=True, widths=(512,), backward=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert all(kernel_width(C, nh, G) == 512 for C, nh, G in ROUTES)
    return torch.device("cuda")


def _fan_in(params, C):
    """params on the card, the weight matrices scaled by sqrt(64 / C)."""
    f = (64.0 / C) ** 0.5
    return [(p * f if p.dim() >= 2 else p).cuda() for p in params]


def _case(C, nh, G, kind, N, L, precise, seed):
    """(arguments of ftf_bwd_plain, its keywords) of one backward case:
    the forward's hiddens from the kernels, the cotangent zeroed near the
    LeakyReLU's kink."""
    g = torch.Generator().manual_seed(seed)
    D = 2 if kind == "freq" else 1
    x = torch.randn((N, L, C), generator=g).cuda()
    params = _fan_in(_ftf_params(g, C, G, D), C)
    lookback = {"freq": None, "time_band0": 0, "time_band5": 5}[kind]
    out, hid = ftf_forward_with_hidden(x, *params, bidirectional=D == 2,
                                       num_heads=nh, lookback=lookback,
                                       precise=precise)
    act = out - x - hid.sum(dim=0).reshape(N, L, C)
    comb = torch.where(act >= 0, act, act / 0.2)
    dout = torch.randn((N, L, C), generator=g).cuda()
    dout = torch.where(comb.abs() < (1e-3 if precise else 5e-2), 0.0, dout)
    return ((x, *params, hid, dout, D == 2, nh, lookback),
            dict(bidirectional=D == 2, num_heads=nh, lookback=lookback,
                 precise=precise))


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("N,L", [(1, 1), (4, 33), (9, 129), (70, 7)])
@pytest.mark.parametrize("kind", ["freq", "time_band0", "time_band5"])
@pytest.mark.parametrize("C,nh,G", ROUTES)
def test_ftf_backward_at_512(card, C, nh, G, kind, N, L, mode):
    """fused_ftf_bwd against ftf_bwd_plain on the card: every gradient
    within TOL of its largest magnitude, or in bf16 as close to the f32
    plain version as the bf16 plain version is."""
    precise = mode == "precise"
    args, kw = _case(C, nh, G, kind, N, L, precise,
                     C * 1000 + nh * 10 + G + L + N)
    before = fused_ftf_bwd.launches
    got = fused_ftf_bwd(*args[:17], **kw)
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


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("nh,G,walk", [(1, 1, "bptt_step_kernel"),
                                       (2, 2, "bptt_cluster_kernel")])
def test_slot_walks_at_512(card, nh, G, walk, mode):
    """One group of 512 takes the step-synchronous walk, a launch a step;
    two groups of 256 the cluster walk with the slot in grid z: the
    kernels one backward launches, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    precise = mode == "precise"
    args, kw = _case(512, nh, G, "freq", 5, 9, precise, 11)
    fused_ftf_bwd(*args[:17], **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_ftf_bwd(*args[:17], **kw)
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.key_averages():
        for name in ("bptt_step_kernel", "bptt_cluster_kernel",
                     "gate_tc_kernel", "gate_kernel"):
            if name + "<" in evt.key or name + "(" in evt.key:
                counts[name] = counts.get(name, 0) + evt.count
    gate = "gate_kernel" if precise else "gate_tc_kernel"
    assert counts.get(gate) == 1, counts
    assert counts.get(walk) == (9 if walk == "bptt_step_kernel" else 1), \
        counts


@pytest.mark.parametrize("mode", ["bf16", "precise"])
@pytest.mark.parametrize("nh,G", [(4, 4), (1, 1)])
@pytest.mark.parametrize("kind", ["freq", "time_band5"])
def test_saved_hidden_at_512(card, nh, G, kind, mode):
    """Under grad the width-512 forward keeps the hiddens its kernels write
    (the backward's operand): its output is bit-equal to the no-grad
    forward's, and the hiddens are within TOL of the plain forward's."""
    g = torch.Generator().manual_seed(nh * 10 + G)
    D = 2 if kind == "freq" else 1
    x = torch.randn((6, 33, 512), generator=g).cuda()
    params = _fan_in(_ftf_params(g, 512, G, D), 512)
    kw = dict(bidirectional=D == 2, num_heads=nh,
              lookback=None if kind == "freq" else 5,
              precise=mode == "precise")
    with torch.no_grad():
        plain_out = fused_ftf_block(x, *params, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in [x] + params]
    out = fused_ftf_block(*leaves, **kw)
    assert torch.equal(out.detach(), plain_out)
    _, hid = ftf_forward_with_hidden(x, *params, **kw)
    _, ref = ftf_block_reference(x, *params, return_hidden=True, **kw)
    err = (hid - ref).abs().max().item()
    assert err <= TOL[mode], err

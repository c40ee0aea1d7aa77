"""The FTF-block forward CUDA kernels (lct_gan_tpu_torch/csrc/ftf.cu) on the
card against their plain PyTorch version on the same inputs, at edge shapes
the serving path does not reach: L = 1 and 2, the frequency (33) and time
(129) lengths, one full key tile (64), the streaming length (251), the
longest L (512); one and two
GRU directions; key bias; lookback 0, 16 and 64; sequence counts that are
not a multiple of the GRU kernel's 16-sequence tile. Each case runs the
tensor-core bf16 design and, for a subset, the all-f32 one; the save-hidden
forward (under grad) is bit-equal to the no-grad one.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_ftf.py

Tolerances are chip_smoke.py's: precise (all f32) 1e-3, sum order only;
bf16 3e-2, where a different f32 sum order can move a rounded operand by one
bf16 ulp.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                       ftf_forward_with_hidden,
                                       fused_ftf_block)

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


def _inputs(N, L, bidi, key_bias, seed):
    g = torch.Generator().manual_seed(seed)
    D = 2 if bidi else 1

    def u(*s, b=0.25):
        return b * (2 * torch.rand(s, generator=g) - 1)

    params = [1 + 0.1 * u(64), 0.1 * u(64), u(D, 4, 16, 48), u(D, 4, 16, 48),
              u(D, 4, 48), u(D, 4, 48), 1 + 0.1 * u(64), 0.1 * u(64),
              u(64, 192), 0.1 * u(192), u(64, 64), 0.1 * u(64),
              u(128 if bidi else 64, 64), 0.1 * u(64)]
    x = torch.randn((N, L, 64), generator=g)
    kb = None
    if key_bias:
        valid = torch.randint(max(1, L // 3), L + 1, (N,), generator=g)
        kb = torch.where(torch.arange(L)[None, :] < valid[:, None], 0.0,
                         -1e30)
        kb = kb.cuda()
    return x.cuda(), [p.cuda() for p in params], kb


CASES = [
    # N, L, bidirectional, lookback, key bias
    (1, 1, True, None, False),    # one row: no recurrence, one key
    (3, 2, False, 0, False),      # lookback 0: the self key alone
    (37, 33, True, None, False),  # the frequency block, ragged 16-seq tile
    (5, 33, True, None, True),
    (6, 64, True, None, True),    # one full key tile: the single-walk path
    (19, 129, False, None, True),  # the time block with key bias
    (7, 129, False, 16, False),
    (3, 251, False, 64, True),    # the streaming block's length and band
    (2, 512, False, None, False),  # the longest L the kernels take
    (2, 512, True, 16, True),
]


@pytest.mark.parametrize("N,L,bidi,lookback,kb", CASES)
def test_ftf_kernel_matches_plain_bf16(card, N, L, bidi, lookback, kb):
    _check(N, L, bidi, lookback, kb, precise=False)


@pytest.mark.parametrize("N,L,bidi,lookback,kb", CASES[::2])
def test_ftf_kernel_matches_plain_precise(card, N, L, bidi, lookback, kb):
    _check(N, L, bidi, lookback, kb, precise=True)


def _check(N, L, bidi, lookback, key_bias, precise):
    x, params, kb = _inputs(N, L, bidi, key_bias, seed=100 * L + N)
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              key_bias=kb, precise=precise)
    before = fused_ftf_block.launches
    with torch.no_grad():
        out = fused_ftf_block(x, *params, **kw)
    torch.cuda.synchronize()
    assert fused_ftf_block.launches == before + 1
    assert fused_ftf_block.design == ("simt-f32" if precise else "tc-bf16")
    ref, ref_hid = ftf_block_reference(x, *params, return_hidden=True, **kw)
    assert out.shape == (N, L, 64) and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= TOL[precise], err
    again, hid = ftf_forward_with_hidden(x, *params, **kw)
    assert torch.equal(out, again)
    assert hid.shape == ref_hid.shape
    assert (hid - ref_hid).abs().max().item() <= TOL[precise]


@pytest.mark.parametrize("bidi,lookback", [(True, None), (False, 16)])
def test_save_hidden_forward_is_bit_equal(card, bidi, lookback):
    x, params, _ = _inputs(21, 40, bidi, False, seed=5)
    kw = dict(bidirectional=bidi, num_heads=4, lookback=lookback,
              precise=False)
    with torch.no_grad():
        plain_out = fused_ftf_block(x, *params, **kw)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    out = fused_ftf_block(*leaves, **kw)
    assert out.requires_grad
    assert torch.equal(out.detach(), plain_out)

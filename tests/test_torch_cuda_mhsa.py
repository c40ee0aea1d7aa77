"""The MHSA CUDA kernels (lct_gan_tpu_torch/csrc/mhsa.cu) on the card against
their plain PyTorch version on the same inputs, at edge shapes the serving
path does not reach: L = 1, L below and at one 64-key tile (one walk over
the keys), L just above a tile boundary, a band across 128-row query tiles,
the longest L (1024), lookback 0, 16 and 64, rows whose whole band is
key-masked, N = 1, and row counts that are not a multiple of the tiles. Each
case runs the tensor-core bf16 design and, for a subset, the all-f32 one.

Skips without a GPU. On a machine with the card (no JAX needed there):

    python -m pytest --noconftest -s -q tests/test_torch_cuda_mhsa.py

Tolerances are chip_smoke.py's: precise (all f32) 1e-3, sum order only;
bf16 3e-2, where a different f32 sum order can move a rounded operand by one
bf16 ulp.
"""

import pytest
import torch

from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference

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


def _inputs(N, L, kb_mode, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, L, 64), generator=g)
    params = [0.25 * (2 * torch.rand(s, generator=g) - 1)
              for s in ((64, 192), (192,), (64, 64), (64,))]
    kb = None
    if kb_mode == "tail":
        valid = torch.randint(max(1, L // 3), L + 1, (N,), generator=g)
        kb = torch.where(torch.arange(L)[None, :] < valid[:, None], 0.0,
                         -1e30)
    elif kb_mode == "rows":  # sequence 0: every key masked
        kb = torch.zeros((N, L))
        kb[0] = -1e30
    return x, params, kb


CASES = [
    # N, L, lookback, key bias
    (1, 1, None, None),       # one query, one key
    (3, 17, None, "tail"),    # below one tile
    (2, 17, 0, "tail"),       # the self key alone
    (4, 64, None, "tail"),    # one full key tile: the single-walk path
    (3, 200, 16, None),       # a band across 128-row query tiles
    (2, 513, 64, "tail"),     # tails whose whole band is masked
    (1, 516, None, "rows"),   # N = 1, every key masked: uniform rows
    (5, 644, None, "tail"),   # the 163,840-sample bucket's length
    (2, 644, 64, "rows"),
    (1, 1024, None, "tail"),  # the longest L the kernel takes
    (3, 1024, 0, None),
]


@pytest.mark.parametrize("N,L,lookback,kb_mode", CASES)
def test_mhsa_kernel_matches_plain_bf16(card, N, L, lookback, kb_mode):
    _check(N, L, lookback, kb_mode, precise=False)


@pytest.mark.parametrize("N,L,lookback,kb_mode", CASES[::2])
def test_mhsa_kernel_matches_plain_precise(card, N, L, lookback, kb_mode):
    _check(N, L, lookback, kb_mode, precise=True)


def _check(N, L, lookback, kb_mode, precise):
    x, params, kb = _inputs(N, L, kb_mode, seed=7 * L + N)
    x, *params = [t.cuda() for t in [x] + params]
    kb = None if kb is None else kb.cuda()
    kw = dict(num_heads=4, lookback=lookback, key_bias=kb, precise=precise)
    before = fused_mhsa.launches
    with torch.no_grad():
        out = fused_mhsa(x, *params, **kw)
    torch.cuda.synchronize()
    assert fused_mhsa.launches == before + 1
    assert fused_mhsa.design == ("simt-f32" if precise else "tc-bf16")
    ref = mhsa_reference(x, *params, **kw)
    assert out.shape == (N, L, 64) and torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= TOL[precise], err
    with torch.no_grad():
        again = fused_mhsa(x, *params, **kw)
    assert torch.equal(out, again)


def test_mhsa_kernel_rejects_longer_sequences(card):
    x = torch.zeros((1, 1025, 64), device="cuda")
    p = [torch.zeros(s, device="cuda") for s in ((64, 192), (192,), (64, 64),
                                                  (64,))]
    with pytest.raises(ValueError, match="L <= 1024"):
        fused_mhsa(x, *p)


def test_ex2_rate_probe(card):
    """The exp-rate probe behind chip_smoke.py's exp floor: a launch over
    every SM runs and gives a rate of the order of the card's special-
    function units (16 per SM per clock: ~4e12 exps/s on an H100 SXM)."""
    from lct_gan_tpu_torch.ops.probe import ex2_rate

    rate = ex2_rate(iters=256)
    assert 1e11 < rate < 1e14, rate

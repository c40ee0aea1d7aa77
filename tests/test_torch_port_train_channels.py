"""Training at bottleneck widths other than C = 64, on the CPU: the FTF
backward of the port against the JAX package's at C in {16, 32, 48, 96}
with a few (num_heads, gru_groups) each, the route the CUDA wrapper takes
at C = 48 and 96 (operands zero-padded to 64 and 128, gradients gathered
back), and the gradients of a mask loss through a whole LctEnhancer at
enc_channels (12, 24, 48) against jax.grad of the JAX enhancer.

Tolerances, as tests/test_torch_port_train_widths.py holds them at C = 64:
  * `ftf_bwd_reference` against the JAX package's backward kernel
    `fused_ftf_bwd` in interpret mode, same inputs and hiddens: precise
    within 2e-5 (the JAX package's band); bf16 with the cotangent zeroed
    within 5e-2 of the LeakyReLU's kink, within 1e-2 of each gradient's
    largest magnitude and correlation > 0.9999 (a value f32 sum order
    moves across a bf16 rounding boundary moves by one bf16 ulp, and the
    recurrence carries it on);
  * the padded route, all f32, through the plain backward with the
    kernels' LayerNorm divisor (the true C) and score scale (q scaled by
    sqrt(padded / true head width), its gradient scaled back): within 1e-5
    of each gradient's largest magnitude of the unpadded backward (f32 sum
    order; exact where nothing is summed in another order);
  * the enhancer's gradients, both all f32: within 1e-4 of each tensor's
    largest magnitude (sum order through three FTF blocks and the convs).
On the CPU every wrapper computes its plain version and counts no launch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.losses import mask_mse_loss as jax_mask_mse_loss
from lct_gan_tpu.models.generator import LCTGeneratorConfig as JaxConfig
from lct_gan_tpu.models.generator import LctEnhancer as JaxEnhancer
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu.ops.ftf_bwd import fused_ftf_bwd as jax_fused_ftf_bwd
from lct_gan_tpu_torch.convert import jax_params_to_state_dict
from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer)
from lct_gan_tpu_torch.ops import ftf_bwd as ftf_bwd_ops
from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, kernel_operands
from lct_gan_tpu_torch.ops.ftf_bwd import (ftf_bwd_reference, fused_ftf_bwd,
                                           true_gradients)
from lct_gan_tpu_torch.ops.gru import unpack_gru_slot_grads

from test_torch_port_channels import _kernel_heads
from test_torch_port_widths import ORDER, _ftf_params

# (C, num_heads, gru_groups, bidirectional, lookback): heads of 32 .. 1
# channels, groups of 48 .. 1 units (slots of 16, dense slots of 16, 32
# and, padded, 128), the padded widths' zero heads and groups; each width
# as the frequency block and as the time block with a band of 5.
CASES = [(16, 2, 4, True, None), (16, 16, 1, False, 5),
         (32, 8, 2, False, 5), (32, 1, 32, True, None),
         (48, 3, 3, True, None), (48, 16, 4, False, 5),
         (96, 6, 12, False, 5), (96, 32, 1, True, None)]
BWD_KINDS = [(True, None), (False, 5)]   # frequency block; time, band 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(C, nh, G, bidi, seed):
    N, L = (5, 9) if bidi else (3, 11)
    rng = np.random.default_rng(seed + C + 7 * nh + G)
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    w = rng.standard_normal((N, L, C)).astype(np.float32)
    p = _ftf_params(rng, bidi, G, C)
    return x, w, [p[k] for k in ORDER]


def _jax_hid(hid, N, L):
    """The port's hid [D, N*L, C] -> the JAX kernel's [N, L, D*C]."""
    D, _, C = hid.shape
    return hid.reshape(D, N, L, C).permute(1, 2, 0, 3).reshape(N, L, D * C)


def _backward_pair(C, nh, G, bidi, lookback, precise, seed):
    """(port, JAX) backward on the same inputs and the port's hiddens; in
    bf16 mode the cotangent is zeroed near the LeakyReLU's kink."""
    x, w, p = _inputs(C, nh, G, bidi, seed)
    N, L, _ = x.shape
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, num_heads=nh, lookback=lookback)
    out, hid = ftf_block_reference(torch.from_numpy(x), *tp,
                                   precise=precise, return_hidden=True, **kw)
    if not precise:
        act = out - torch.from_numpy(x) - hid.sum(dim=0).reshape(N, L, C)
        comb = torch.where(act >= 0, act, act / 0.2)
        w = np.where(comb.abs().numpy() < 5e-2, 0.0, w).astype(np.float32)
    before = fused_ftf_bwd.launches
    got = fused_ftf_bwd(torch.from_numpy(x), *tp, hid, torch.from_numpy(w),
                        precise=precise, **kw)
    assert fused_ftf_bwd.launches == before
    want = jax_fused_ftf_bwd(
        jnp.asarray(x), *map(jnp.asarray, p),
        jnp.asarray(_jax_hid(hid, N, L).numpy()), jnp.asarray(w),
        block_seqs=4, sub=2, interpret=True, precise=precise, **kw)
    assert len(got) == len(want) == 15
    return got, [np.asarray(b) for b in want]


@pytest.mark.parametrize("C,nh,G,bidi,lookback", CASES)
def test_precise_plain_backward_matches_jax_kernel(C, nh, G, bidi, lookback):
    got, want = _backward_pair(C, nh, G, bidi, lookback, True, seed=4)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C,nh,G,bidi,lookback", CASES)
def test_bf16_plain_backward_matches_jax_kernel(C, nh, G, bidi, lookback):
    got, want = _backward_pair(C, nh, G, bidi, lookback, False, seed=5)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * scale
        assert np.corrcoef(a.numpy().ravel(), b.ravel())[0, 1] > 0.9999


def _kernel_ln(C):
    """ftf_bwd's LayerNorm forward and backward as the kernels take them
    on padded rows: sums over every channel (the padded ones hold 0 or have
    scale 0), divided by the true width C."""
    def ln_fwd(x, scale, bias, eps=1e-6):
        mu = x.sum(-1, keepdim=True) / C
        var = torch.clamp((x * x).sum(-1, keepdim=True) / C - mu * mu,
                          min=0.0)
        rstd = torch.rsqrt(var + eps)
        xhat = (x - mu) * rstd
        return xhat * scale + bias, xhat, rstd

    def ln_bwd(dy, xhat, rstd, scale):
        dxh = dy * scale
        return rstd * (dxh - dxh.sum(-1, keepdim=True) / C
                       - xhat * (dxh * xhat).sum(-1, keepdim=True) / C)
    return ln_fwd, ln_bwd


@pytest.mark.parametrize("bidi,lookback", BWD_KINDS)
@pytest.mark.parametrize("C,nh,G", [(48, 3, 3), (48, 16, 4), (48, 1, 16),
                                    (96, 6, 12), (96, 32, 2), (96, 1, 1)])
def test_padded_backward_route_is_the_plain_backward(monkeypatch, C, nh, G,
                                                     bidi, lookback):
    """What the CUDA wrapper does at C = 48 and 96, run through the plain
    backward: the forward's padded operands (`kernel_operands`: channels,
    heads and GRU groups zero-padded, the GRU packed into slots), the
    hiddens and the cotangent padded as x, then the slot-layout gradients
    unpacked and gathered back (`true_gradients`): the unpadded backward's
    15 gradients."""
    x, w, p = _inputs(C, nh, G, bidi, seed=6)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, lookback=lookback, precise=True)
    _, hid = ftf_block_reference(tx, *tp, num_heads=nh, return_hidden=True,
                                 **kw)
    want = ftf_bwd_reference(tx, *tp, hid, tw, num_heads=nh, **kw)

    kops, cidx = kernel_operands([tx, *tp, None], nh)
    CK = padding.kernel_width(C, nh, G)
    assert cidx is not None and kops[0].shape[-1] == CK
    nhk, kops[9], kops[10] = _kernel_heads(C, nh, kops[9], kops[10])
    monkeypatch.setattr(ftf_bwd_ops, "_ln_fwd", _kernel_ln(C)[0])
    monkeypatch.setattr(ftf_bwd_ops, "_ln_bwd", _kernel_ln(C)[1])
    got = list(ftf_bwd_reference(*kops[:15], padding.pad_last(hid, cidx, CK),
                                 padding.pad_last(tw, cidx, CK),
                                 num_heads=nhk, **kw))
    # q was scaled by r = sqrt(padded / true head width): its gradient by r.
    r = float(padding.head_width(C // nh) / (C // nh)) ** 0.5
    got[9][:, :CK] *= r
    got[10][:CK] *= r
    got[3:7] = unpack_gru_slot_grads(*got[3:7],
                                     padding.padded_groups(C, G, CK))
    got = true_gradients(got, C, G, nh)
    assert len(got) == len(want) == 15
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale


def test_enhancer_gradients_match_jax():
    """Gradients of the compressed-mask MSE against a seeded target through
    a whole LctEnhancer at enc_channels (12, 24, 48) (4 heads of 12, 4 GRU
    groups of 12): the port's (its FTF blocks' backward is fused_ftf_bwd's
    plain version) against jax.grad of the JAX enhancer, both all f32, from
    the JAX package's initialised parameters. B = 1 x 0.25 s."""
    enc = (12, 24, 48)
    rng = np.random.default_rng(48)
    wave = (0.1 * rng.standard_normal((1, 4000))).astype(np.float32)
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(enc_channels=enc,
                                            dec_channels=enc[::-1]))
    with pallas_override(None):
        params = jax.jit(jax_enh.init)(jax.random.PRNGKey(3),
                                       jnp.asarray(wave))["params"]
        mask = jax_enh.apply({"params": params}, jnp.asarray(wave))[1]
        target = rng.uniform(0.0, 1.0, mask.shape).astype(np.float32)

        def loss(p):
            return jax_mask_mse_loss(
                jax_enh.apply({"params": p}, jnp.asarray(wave))[1],
                jnp.asarray(target))

        want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want))

    port = LctEnhancer(gen_cfg=LCTGeneratorConfig(
        enc_channels=enc, dec_channels=enc[::-1]), precise=True)
    port.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    before = fused_ftf_bwd.launches
    got_loss = ((port(torch.from_numpy(wave))[1]
                 - torch.from_numpy(target)) ** 2).mean()
    got_loss.backward()
    assert fused_ftf_bwd.launches == before
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) == set(want) - {"stft.window"}
    for name, p in named.items():
        b = want[name].numpy()
        assert p.grad is not None and p.grad.shape == b.shape, name
        scale = np.abs(b).max()
        assert np.abs(p.grad.numpy() - b).max() <= 1e-4 * scale, name

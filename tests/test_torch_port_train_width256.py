"""Training at kernel width 256 (bottleneck layouts of 129-256 channels),
on the CPU: the FTF backward of the port against the JAX package's at
C = 256 at every route the CUDA backward of that width takes (a head of
256 with GRU slots of 16, heads and slots of 64 and of 128, the GRU slot
of 256 that a cluster of blocks walks on the card), the slot packing of
that width's GRU gradients, and the gradients of a mask loss through a
whole LctEnhancer at enc_channels (64, 128, 256) against jax.grad of the
JAX enhancer. The padded layouts (100, 5, 5), (120, 3, 3) and (144, 4, 4)
into 256 are held by tests/test_torch_port_any_width.py::
test_padded_backward_route_is_the_plain_backward.

Tolerances, as tests/test_torch_port_train_channels.py sets them:
  * `ftf_bwd_reference` against the JAX package's backward kernel
    `fused_ftf_bwd` in interpret mode, same inputs and hiddens: precise
    within 2e-5; bf16 with the cotangent zeroed within 5e-2 of the
    LeakyReLU's kink, within 1e-2 of each gradient's largest magnitude
    and correlation > 0.9999;
  * the slot packing: exact;
  * the enhancer's gradients, both all f32: within 1e-4 of each tensor's
    largest magnitude.
Shapes are the shortest that reach each route (N <= 2, L <= 7), with
weights at a fan-in scale, sqrt(64 / C), so that the activations are as
large as at C = 64. On the CPU every wrapper computes its plain version
and counts no launch.
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
from lct_gan_tpu_torch.convert import (jax_params_to_state_dict,
                                        state_dict_to_jax_params)
from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer)
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference
from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
from lct_gan_tpu_torch.ops.gru import (gru_slot, pack_gru_slots,
                                       unpack_gru_slot_grads)
from lct_gan_tpu_torch.ops.padding import head_width, kernel_width

from test_torch_port_train_channels import _jax_hid
from test_torch_port_widths import ORDER, _ftf_params

C = 256
# (num_heads, gru_groups, bidirectional, lookback): the frequency block and
# the time block with a band of 5.
CASES = [(1, 16, True, None), (4, 4, False, 5), (2, 2, True, None),
         (16, 1, False, 5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(nh, G, bidi, seed, C=C):
    N, L = (2, 4) if bidi else (1, 7)
    rng = np.random.default_rng(seed + 7 * nh + G)
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    w = rng.standard_normal((N, L, C)).astype(np.float32)
    f = np.float32((64.0 / C) ** 0.5)
    p = {k: (v * f if v.ndim >= 2 else v)
         for k, v in _ftf_params(rng, bidi, G, C).items()}
    return x, w, [p[k] for k in ORDER]


def _backward_pair(nh, G, bidi, lookback, precise, seed, C=C):
    """(port, JAX) backward on the same inputs and the port's hiddens, at
    C channels; in bf16 mode the cotangent is zeroed near the LeakyReLU's
    kink."""
    x, w, p = _inputs(nh, G, bidi, seed, C)
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


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("nh,G,bidi,lookback", CASES)
def test_plain_backward_matches_jax_kernel_at_256(nh, G, bidi, lookback,
                                                  precise):
    assert kernel_width(C, nh, G) == 256
    got, want = _backward_pair(nh, G, bidi, lookback, precise, seed=23)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if precise:
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
            continue
        scale = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * scale
        assert np.corrcoef(a.numpy().ravel(), b.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("G,slot", [(1, 256), (2, 128), (4, 64), (8, 64),
                                    (16, 16), (64, 16)])
def test_gru_slot_grads_round_trip_at_256(G, slot):
    """The wrapper packs C = 256's GRU weights into the kernels' slots
    (one of 256 for one group, two of 128 for two, dense slots of 64,
    slots of 16) and takes the slot-layout gradients apart with the
    inverse: on the packed weights themselves the round trip is exact,
    and a group's block of its slot holds its own weights."""
    rng = np.random.default_rng(G)
    H = C // G
    w_ih, w_hh = (torch.from_numpy(rng.standard_normal(
        (2, G, H, 3 * H)).astype(np.float32)) for _ in range(2))
    b_ih, b_hh = (torch.from_numpy(rng.standard_normal(
        (2, G, 3 * H)).astype(np.float32)) for _ in range(2))
    assert gru_slot(G, C) == slot
    packed = pack_gru_slots(w_ih, w_hh, b_ih, b_hh)
    assert tuple(packed[0].shape) == (2, C // slot, slot, 3 * slot)
    assert tuple(packed[2].shape) == (2, C // slot, 3 * slot)
    back = unpack_gru_slot_grads(*packed, G)
    for a, b in zip(back, (w_ih, w_hh, b_ih, b_hh)):
        assert torch.equal(a, b)
    # Group g's input unit i, gate q, unit j sits at its slot's row
    # (g % k) H + i, column q slot + (g % k) H + j.
    k = slot // H
    for g in (0, G - 1):
        s, o = divmod(g, k)
        blk = packed[0][1, s, o * H:(o + 1) * H].reshape(H, 3, slot)
        assert torch.equal(blk[:, :, o * H:(o + 1) * H],
                           w_ih[1, g].reshape(H, 3, H))


def test_enhancer_gradients_match_jax_at_256():
    """Gradients of the compressed-mask MSE against a seeded target through
    a whole LctEnhancer at enc_channels (64, 128, 256) (4 heads of 64, 4
    GRU groups of 64: kernel width 256): the port's (its FTF blocks'
    backward is fused_ftf_bwd's plain version) against jax.grad of the JAX
    enhancer, both all f32, from the port's seeded initial parameters.
    B = 1 x 768 samples (48 ms, 4 STFT frames: the fewest the decoder's
    transposed convs take), a time block of L = 7."""
    enc = (64, 128, 256)
    assert kernel_width(enc[-1], 4, 4) == 256 and head_width(64) == 64
    rng = np.random.default_rng(256)
    wave = (0.1 * rng.standard_normal((1, 768))).astype(np.float32)
    torch.manual_seed(256)
    port = LctEnhancer(gen_cfg=LCTGeneratorConfig(
        enc_channels=enc, dec_channels=enc[::-1]), precise=True)
    seen = []
    hook = port.gen.GRUt1.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    before = fused_ftf_bwd.launches
    mask = port(torch.from_numpy(wave))[1]
    target = rng.uniform(0.0, 1.0, tuple(mask.shape)).astype(np.float32)
    got_loss = ((mask - torch.from_numpy(target)) ** 2).mean()
    got_loss.backward()
    hook.remove()
    assert fused_ftf_bwd.launches == before
    assert seen and all(s[-1] == 256 and s[1] == 7 for s in seen)

    params = state_dict_to_jax_params(
        {k: v.detach().numpy() for k, v in port.state_dict().items()})
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(enc_channels=enc,
                                            dec_channels=enc[::-1]))
    with pallas_override(None):
        def loss(p):
            return jax_mask_mse_loss(
                jax_enh.apply({"params": p}, jnp.asarray(wave))[1],
                jnp.asarray(target))

        want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(port.named_parameters())
    assert set(named) == set(want) - {"stft.window"}
    for name, p in named.items():
        b = want[name].numpy()
        assert p.grad is not None and p.grad.shape == b.shape, name
        scale = np.abs(b).max()
        assert np.abs(p.grad.numpy() - b).max() <= 1e-4 * scale, name

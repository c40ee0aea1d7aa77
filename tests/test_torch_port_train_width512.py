"""Training at kernel width 512 (bottleneck layouts of 257-512 channels),
on the CPU: the FTF backward of the port against the JAX package's at
C = 512 at every route the CUDA backward of that width takes (a head of
512 with GRU slots of 16, heads and slots of 64, of 128 with a band, the
slots of 256 that clusters of blocks walk, one head of 8 channels with the
one slot of 512 that the step-synchronous walk takes), the backward
wrapper's padding route at (272, 1, 1), (300, 3, 3) and (320, 5, 5) into
512, the slot packing of that width's GRU gradients, the width-512
backward's build command, the card's training widths (every layout that
fits 512 channels, as serving) and the gradients of a mask loss through a
whole LctEnhancer at enc_channels (128, 256, 512) against jax.grad of the
JAX enhancer.

Tolerances, width 256's (tests/test_torch_port_train_width256.py):
  * `ftf_bwd_reference` against the JAX package's backward kernel
    `fused_ftf_bwd` in interpret mode, same inputs and hiddens: precise
    within 2e-5; bf16 with the cotangent zeroed within 5e-2 of the
    LeakyReLU's kink, within 1e-2 of each gradient's largest magnitude
    and correlation > 0.9999;
  * the padding route against the unpadded plain backward: 1e-5 of each
    gradient's largest magnitude (f32, sum order only);
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
from lct_gan_tpu_torch.convert import (jax_params_to_state_dict,
                                        state_dict_to_jax_params)
from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer,
                                                check_card_widths)
from lct_gan_tpu_torch.ops import _build, padding
from lct_gan_tpu_torch.ops import ftf_bwd as ftf_bwd_ops
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference, kernel_operands
from lct_gan_tpu_torch.ops.ftf_bwd import (fused_ftf_bwd, ftf_bwd_reference,
                                           true_gradients)
from lct_gan_tpu_torch.ops.gru import (gru_slot, pack_gru_slots,
                                       unpack_gru_slot_grads)
from lct_gan_tpu_torch.ops.library import (BACKWARD_WIDTHS, KERNEL_WIDTHS,
                                           card_takes)
from lct_gan_tpu_torch.ops.padding import head_width, kernel_width

from test_torch_port_any_width import _close, _ftf
from test_torch_port_channels import _kernel_heads
from test_torch_port_train_channels import _kernel_ln
from test_torch_port_train_width256 import _backward_pair
from test_torch_port_widths import ORDER

C = 512
# (num_heads, gru_groups, bidirectional, lookback): the frequency block
# with a head of 512 and slots of 16, heads and slots of 64, heads and
# slots of 256 (two cluster walks); the time block with a band of 5 at
# heads and slots of 128, and at 64 heads of 8 with one slot of 512 (the
# step walk).
CASES = [(1, 32, True, None), (8, 8, True, None), (4, 4, False, 5),
         (2, 2, True, None), (64, 1, False, 5)]
# Layouts padded to kernel width 512: a head and a group of 272 (widened to
# 512), heads and groups of 100 (to 128) and of 64 (five of them: 320
# channels, past 256).
PADDED = [(272, 1, 1), (300, 3, 3), (320, 5, 5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("nh,G,bidi,lookback", CASES)
def test_plain_backward_matches_jax_kernel_at_512(nh, G, bidi, lookback,
                                                  precise):
    assert kernel_width(C, nh, G) == 512
    got, want = _backward_pair(nh, G, bidi, lookback, precise, 29, C)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if precise:
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)
            continue
        scale = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * scale
        assert np.corrcoef(a.numpy().ravel(), b.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("C,nh,G", PADDED)
@pytest.mark.parametrize("bidi", [True, False])
def test_padded_backward_route_at_512(monkeypatch, C, nh, G, bidi):
    """The backward wrapper's route into kernel width 512, run through the
    plain backward: the forward's padded operands, the hiddens and the
    cotangent padded as x, the slot-layout gradients unpacked and gathered
    back (`true_gradients`): the unpadded backward's 15 gradients."""
    x, p, _, kw = _ftf(C, nh, G, "freq" if bidi else "time_lookback", seed=5)
    rng = np.random.default_rng(C + G)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    tp = [torch.from_numpy(p[k]) for k in ORDER]
    kw = dict(kw, precise=True)
    nh = kw.pop("num_heads")
    _, hid = ftf_block_reference(tx, *tp, num_heads=nh, return_hidden=True,
                                 **kw)
    want = ftf_bwd_reference(tx, *tp, hid, tw, num_heads=nh, **kw)

    CK = padding.kernel_width(C, nh, G)
    assert CK == 512
    kops, cidx = kernel_operands([tx, *tp, None], nh)
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
        _close(a, b)


@pytest.mark.parametrize("G,slot", [(1, 512), (2, 256), (4, 128), (8, 64),
                                    (32, 16)])
def test_gru_slot_grads_round_trip_at_512(G, slot):
    """The wrapper packs C = 512's GRU weights into the kernels' slots (one
    of 512 for one group, two of 256 for two, four of 128, dense slots of
    64, slots of 16) and takes the slot-layout gradients apart with the
    inverse: on the packed weights themselves the round trip is exact, and
    a group's block of its slot holds its own weights."""
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
    k = slot // H
    for g in (0, G - 1):
        s, o = divmod(g, k)
        blk = packed[0][1, s, o * H:(o + 1) * H].reshape(H, 3, slot)
        assert torch.equal(blk[:, :, o * H:(o + 1) * H],
                           w_ih[1, g].reshape(H, 3, H))


def test_backward_build_command_at_512():
    """Kernel width 512 builds the FTF backward (csrc/ftf_bwd.cu) with
    -DLCT_C=512 beside its forward sources at the first backward, into a
    library of its own; widths past 512 have none, forward or backward."""
    assert BACKWARD_WIDTHS == KERNEL_WIDTHS and BACKWARD_WIDTHS[-1] == 512
    assert _build.library_sources(512, backward=True) == [
        "banded", "ftf", "ftf_bwd", "mhsa"]
    cmd = _build.build_command("ftf_bwd", 512, "o.so", "nvcc", verbose=True)
    assert "-DLCT_C=512" in cmd and cmd[-1].endswith("/ftf_bwd.cu")
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
    assert _build.library_path("ftf_bwd", 512, "t").endswith(
        "/libftf_bwd-c512-t.so")
    for backward in (False, True):
        with pytest.raises(ValueError, match="C=1024"):
            _build.library_sources(1024, backward=backward)


def _cfg(C, nh, G):
    enc = (128, 256, C)
    return LCTGeneratorConfig(enc_channels=enc, dec_channels=enc[::-1],
                              num_heads=nh, gru_groups=G)


@pytest.mark.parametrize("C,nh,G", [(512, 1, 1), (512, 4, 4), (512, 2, 2),
                                    (512, 64, 1), (512, 1, 32), *PADDED])
def test_card_trains_layouts_up_to_512(C, nh, G):
    """The card trains every layout it serves, whose padded width fits 512
    channels (card_takes with and without `training` agree), and refuses
    training at twice the channels, past 512, naming enc_channels, the
    flags and the channels the layout needs, before a model runs; the CPU
    trains them all."""
    assert card_takes(C, nh, G, True) and card_takes(C, nh, G)
    check_card_widths(_cfg(C, nh, G), "cuda", training=True)
    need = padding.layout_width(2 * C, nh, G)
    assert need > 512 and not card_takes(2 * C, nh, G, True)
    with pytest.raises(ValueError, match=(
            rf"^the CUDA path takes widths whose padded layout fits 512 "
            rf"channels, got enc_channels\[-1\]={2 * C}, --num_heads {nh}, "
            rf"--gru_groups {G}: the padded layout needs {need} channels "
            rf"\(> 512\); train this configuration with --device cpu")):
        check_card_widths(_cfg(2 * C, nh, G), "cuda", training=True)
    check_card_widths(_cfg(2 * C, nh, G), "cpu", training=True)


def test_enhancer_gradients_match_jax_at_512():
    """Gradients of the compressed-mask MSE against a seeded target through
    a whole LctEnhancer at enc_channels (128, 256, 512) (4 heads of 128, 4
    GRU groups of 128: kernel width 512): the port's (its FTF blocks'
    backward is fused_ftf_bwd's plain version) against jax.grad of the JAX
    enhancer, both all f32, from the port's seeded initial parameters.
    B = 1 x 768 samples (4 STFT frames), a time block of L = 7."""
    enc = (128, 256, 512)
    assert kernel_width(enc[-1], 4, 4) == 512 and head_width(128) == 128
    rng = np.random.default_rng(512)
    wave = (0.1 * rng.standard_normal((1, 768))).astype(np.float32)
    torch.manual_seed(512)
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
    assert seen and all(s[-1] == 512 and s[1] == 7 for s in seen)

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

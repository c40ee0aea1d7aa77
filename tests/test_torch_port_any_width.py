"""The port at bottleneck widths whose padded layout passes the next power
of two, on the CPU: the card's width predicate, the kernel width the
wrappers pick, the padded operands they hand the kernels and the score
scale they pass, and the FTF block and the enhancer against the JAX
package at (40, 4, 4) and (50, 5, 5).

Tolerances:
  The padded operands, run through the plain versions with the kernels'
    LayerNorm divisor (the true C) and score scale (the true head width's):
    1e-5 of the output's largest magnitude against the unpadded block (each
    of the backward's 15 gradients against its own), and exactly 0 on
    every padded output channel.
  Against the JAX package, as tests/test_torch_port_channels.py: f32 1e-4
    (FTF block, enhancer); bf16 against the Pallas kernel in interpret
    mode 2e-2 per 8 of the output's largest magnitude (at least 2e-2), its
    mean under a tenth of the f32 reference's distance from the kernel,
    correlation > 0.99999.
On the CPU every wrapper computes its plain version and counts no launch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.models.generator import LCTGeneratorConfig as JaxConfig
from lct_gan_tpu.models.generator import LctEnhancer as JaxEnhancer
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu.ops.ftf import ftf_block_reference as jax_ftf_reference
from lct_gan_tpu.ops.ftf import fused_ftf_block as jax_ftf
from lct_gan_tpu_torch.convert import jax_params_to_state_dict
from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer,
                                                check_card_widths)
from lct_gan_tpu_torch.ops import ftf as ftf_ops
from lct_gan_tpu_torch.ops import ftf_bwd as ftf_bwd_ops
from lct_gan_tpu_torch.ops import gru as gru_ops
from lct_gan_tpu_torch.ops import padding
from lct_gan_tpu_torch.ops.attention import mhsa_reference, pad_attention
from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa_reference
from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference, fused_ftf_block,
                                       kernel_operands)
from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_reference, true_gradients
from lct_gan_tpu_torch.ops.gru import (grouped_gru_plain, gru_kernel_operands,
                                       unpack_gru_slot_grads)
from lct_gan_tpu_torch.ops.library import card_takes, divisors

from test_torch_port_channels import (_kernel_heads, _kernel_layer_norm,
                                      _padded_channels)
from test_torch_port_train_channels import _kernel_ln
from test_torch_port_widths import (ORDER, _attn_params, _ftf_params, _j,
                                    _key_bias, _t)

# (C, num_heads, gru_groups): a layout of 64 from C = 40; of 80 from C =
# 50, so 128; C = 8 below the narrowest kernel; heads and groups of 20 at
# C = 80, widened to 32.
PADDED = [(40, 4, 4), (50, 5, 5), (8, 2, 2), (80, 4, 4)]
# Layouts padded to kernel width 256: 160, 192 and 256 channels.
PADDED_256 = [(100, 5, 5), (120, 3, 3), (144, 4, 4)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pow2(v):
    p = 1
    while p < v:
        p *= 2
    return p


def _cfg(C, nh, G):
    return LCTGeneratorConfig(enc_channels=(16, 32, C),
                              dec_channels=(C, 32, 16), num_heads=nh,
                              gru_groups=G)


def test_card_takes_every_layout_that_fits_128_channels():
    """Every C from 1 to 288, and 520, 544 and 576 (each past 512), with
    every divisor pair of heads and groups:
    the card serves it exactly when its padded layout (C, each group and
    each head widened to a power of two) fits 512 channels (the widest
    forward kernel), and trains it when the layout fits 512 too (the FTF
    backward's widest), which is every pair up to C = 256 (the name is kept
    from when both stopped at 128); decided from the device argument. The
    CPU takes everything."""
    counts = {False: [0, 0], True: [0, 0]}
    for C in (*range(1, 289), 520, 544, 576):
        for nh in divisors(C):
            for G in divisors(C):
                need = max(C, G * _pow2(C // G), nh * _pow2(C // nh))
                assert card_takes(C, nh, G, True) <= card_takes(C, nh, G)
                for training, top in ((False, 512), (True, 512)):
                    fits = _pow2(need) <= top
                    assert card_takes(C, nh, G, training) == fits, (
                        C, nh, G, training)
                    assert fits or C > top // 2
                    counts[training][fits] += 1
                    if fits:
                        check_card_widths(_cfg(C, nh, G), "cuda",
                                          training=training)
                    else:
                        with pytest.raises(ValueError, match=(
                                rf"fits {top} channels, got "
                                rf"enc_channels\[-1\]={C}, --num_heads "
                                rf"{nh}, --gru_groups {G}: the padded "
                                rf"layout needs {need} channels "
                                rf"\(> {top}\)")):
                            check_card_widths(_cfg(C, nh, G), "cuda:0",
                                              training=training)
                assert card_takes(C, nh, G) == card_takes(C, nh, G, False)
    assert all(n > 0 for c in counts.values() for n in c)


# Layouts past 256 channels: each fits 512, the widest kernel width of the
# forward and the backward alike, so the card serves and trains them.
PAST_256 = [(240, 5, 5, 320), (272, 1, 1, 512), (200, 5, 5, 320),
            (264, 8, 8, 512)]


@pytest.mark.parametrize("C,nh,G,need", [(100, 5, 5, 160), (120, 3, 3, 192),
                                         (144, 4, 4, 256), (256, 1, 1, 256),
                                         *PAST_256])
def test_card_refuses_layouts_past_128_by_name(C, nh, G, need):
    """Training on the card takes the layouts of 129 to 512 channels (the
    FTF backward kernel's widest is 512 now; the name is kept from when it
    was 128), as serving does, and refuses every layout past 512 by name;
    the CPU trains them all."""
    if need <= 512:
        check_card_widths(_cfg(C, nh, G), "cuda", training=True)
        check_card_widths(_cfg(C, nh, G), "cuda", training=False)
    else:
        with pytest.raises(ValueError, match=(
                rf"^the CUDA path takes widths whose padded layout fits 512 "
                rf"channels, got enc_channels\[-1\]={C}, --num_heads {nh}, "
                rf"--gru_groups {G}: the padded layout needs {need} channels "
                rf"\(> 512\); train this configuration with --device cpu")):
            check_card_widths(_cfg(C, nh, G), "cuda", training=True)
    check_card_widths(_cfg(C, nh, G), "cpu", training=True)


@pytest.mark.parametrize("C,nh,G,need", PAST_256)
@pytest.mark.parametrize("training", [False, True])
def test_card_refuses_layouts_past_256_by_name(C, nh, G, need, training):
    """Training and serving on the card take every layout past 256
    channels that fits 512, the widest kernel width of the FTF backward and
    forward alike (the name is kept from when training stopped at 256),
    and refuse the same layouts at twice the channels, past 512, by name;
    the CPU takes them all."""
    check_card_widths(_cfg(C, nh, G), "cuda", training=training)
    C, need, top = 2 * C, 2 * need, 512
    with pytest.raises(ValueError, match=(
            rf"^the CUDA path takes widths whose padded layout fits {top} "
            rf"channels, got enc_channels\[-1\]={C}, --num_heads {nh}, "
            rf"--gru_groups {G}: the padded layout needs {need} channels "
            rf"\(> {top}\); ")):
        check_card_widths(_cfg(C, nh, G), "cuda", training=training)
    check_card_widths(_cfg(C, nh, G), "cpu", training=training)


@pytest.mark.parametrize("C,nh,G,width", [(40, 4, 4, 64), (50, 5, 5, 128),
                                          (8, 2, 2, 16), (24, 3, 3, 32),
                                          (80, 4, 4, 128), (64, 4, 4, 64),
                                          (1, 1, 1, 16), (12, 3, 4, 16)])
def test_kernel_width_of_the_padded_layout(C, nh, G, width):
    """The kernel width is the padded layout's next power of two, at least
    16; the composed path's GRU and attention each take their own (groups
    alone, heads alone), never wider than the block's."""
    assert padding.kernel_width(C, nh, G) == width
    assert max(padding.kernel_width(C, groups=G),
               padding.kernel_width(C, num_heads=nh)) == width
    if width == C:
        assert padding.channel_map(C, G, width) is None
        assert padding.head_map(C, nh, width) is None
    else:
        assert padding.channel_map(C, G, width).max() < width
        assert padding.head_map(C, nh, width).max() < width


@pytest.mark.parametrize("hd", [5, 10, 25, 2, 8, 32, 16, 3, 6, 12, 24, 48,
                                96, 128])
def test_score_scale_is_the_f32_rounding_of_the_true_width(hd):
    """What the wrappers pass the kernels: np.float32(1 / sqrt(hd)), the
    JAX package's 1.0 / float(np.sqrt(hd)) applied to f32 scores; at the
    widths the kernels tabulated before (1 / sqrt(2), (8), (32), and the
    channel set's), the same f32 values as those literals."""
    assert padding.score_scale(hd) == np.float32(1.0 / np.sqrt(hd))
    table = {2: 0.70710678118654752, 8: 0.35355339059327376,
             32: 0.17677669529663688, 16: 0.25, 3: 0.57735026918962584,
             6: 0.40824829046386307, 12: 0.28867513459481292,
             24: 0.20412414523193154, 48: 0.14433756729740646,
             96: 0.10206207261596577, 128: 0.08838834764831843}
    if hd in table:
        assert padding.score_scale(hd) == np.float32(table[hd])


def _close(got, want, tol=1e-5):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


def _heads_past_num_heads_are_zero(in_w, out_w, C, nh):
    """The padded q, k, v columns and context rows of every head past
    num_heads, and the padded channels of each true head, hold zeros."""
    CK = in_w.shape[1] // 3
    hidx = padding.head_map(C, nh, CK)
    dead = _padded_channels(hidx, CK)
    assert dead and all(c >= 0 for c in dead)
    for sec in range(3):
        assert in_w[:, [sec * CK + c for c in dead]].abs().max() == 0
    assert out_w[dead].abs().max() == 0
    hdp = padding.head_width(C // nh)
    assert all(c >= nh * hdp or c % hdp >= C // nh for c in dead)


def _ftf(C, nh, G, kind, seed=0):
    bidi = kind == "freq"
    N, L = (4, 9) if bidi else (3, 12)
    rng = np.random.default_rng(seed + 1000 * C + 10 * nh + G)
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    p = _ftf_params(rng, bidi, G, C)
    kb = _key_bias(rng, N, L) if kind == "time_key_bias" else None
    kw = dict(bidirectional=bidi, num_heads=nh,
              lookback=5 if kind == "time_lookback" else None)
    return x, p, kb, kw


@pytest.mark.parametrize("C,nh,G", PADDED)
@pytest.mark.parametrize("kind", ["freq", "time_key_bias", "time_lookback"])
def test_padded_ftf_operands_are_the_same_block(monkeypatch, C, nh, G,
                                                kind):
    """What the CUDA wrapper hands the FTF kernels (`kernel_operands`,
    padded to the block's kernel width), run through the plain version
    with the kernels' LayerNorm divisor and score scale: its true channels
    equal the unpadded block, out and hiddens, and every padded channel is
    exactly 0."""
    x, p, kb, kw = _ftf(C, nh, G, kind)
    targs = [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]
    want, want_hid = ftf_block_reference(*targs, key_bias=_t(kb),
                                         precise=True, return_hidden=True,
                                         **kw)
    ops, cidx = kernel_operands([*targs, _t(kb)], nh)
    CK = padding.kernel_width(C, nh, G)
    assert cidx is not None and ops[0].shape[-1] == CK
    _heads_past_num_heads_are_zero(ops[9], ops[11], C, nh)
    nhk, ops[9], ops[10] = _kernel_heads(C, nh, ops[9], ops[10])
    monkeypatch.setattr(ftf_ops, "layer_norm", _kernel_layer_norm(C))
    got, hid = ftf_block_reference(*ops[:15], key_bias=ops[15], precise=True,
                                   return_hidden=True,
                                   **dict(kw, num_heads=nhk))
    _close(got[..., cidx], want)
    _close(hid[..., cidx], want_hid)
    pad = _padded_channels(cidx, CK)
    assert got[..., pad].abs().max() == 0 and hid[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,nh,G", PADDED)
def test_padded_attention_and_gru_operands(monkeypatch, C, nh, G):
    """The same for the MHSA and banded wrappers (`pad_attention`, at the
    attention's own kernel width) and the composed GRU's
    (`gru_kernel_operands`, at the GRU's)."""
    rng = np.random.default_rng(C * nh + G)
    x = torch.from_numpy(rng.standard_normal((2, 20, C)).astype(np.float32))
    p = [torch.from_numpy(a) for a in _attn_params(rng, C)]
    kb = torch.from_numpy(_key_bias(rng, 2, 20))
    for ref, kw in ((mhsa_reference, {}),
                    (banded_mhsa_reference, {"lookback": 7})):
        want = ref(x, *p, num_heads=nh, key_bias=kb, precise=True, **kw)
        ops, padded = pad_attention([x, *p, kb], nh)
        assert padded
        assert ops[0].shape[-1] == padding.kernel_width(C, num_heads=nh)
        _heads_past_num_heads_are_zero(ops[1], ops[3], C, nh)
        nhk, ops[1], ops[2] = _kernel_heads(C, nh, ops[1], ops[2])
        got = ref(*ops[:5], num_heads=nhk, key_bias=ops[5], precise=True,
                  **kw)
        _close(got[..., :C], want)
        assert got[..., C:].abs().max() == 0

    q = {k: torch.from_numpy(v) for k, v in _ftf_params(rng, True, G,
                                                         C).items()}
    gru = [q[k] for k in ("ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih",
                          "b_hh")]
    xg = x[:, :9]
    want = grouped_gru_plain(xg, *gru, True)
    ops, idx = gru_kernel_operands([xg, *gru])
    assert ops[0].shape[-1] == padding.kernel_width(C, groups=G)
    monkeypatch.setattr(gru_ops, "layer_norm", _kernel_layer_norm(C))
    got = gru_ops.grouped_gru_plain(*ops, True)
    _close(got[..., idx], want)
    pad = _padded_channels(idx, padding.kernel_width(C, groups=G))
    assert got[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,nh,G", PADDED + PADDED_256)
@pytest.mark.parametrize("bidi", [True, False])
def test_padded_backward_route_is_the_plain_backward(monkeypatch, C, nh, G,
                                                     bidi):
    """The backward wrapper's route, run through the plain backward: the
    forward's padded operands, the hiddens and the cotangent padded as x,
    the slot-layout gradients unpacked and gathered back (`true_gradients`):
    the unpadded backward's 15 gradients."""
    x, p, _, kw = _ftf(C, nh, G, "freq" if bidi else "time_lookback", seed=3)
    rng = np.random.default_rng(C + G)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    tp = [torch.from_numpy(p[k]) for k in ORDER]
    kw = dict(kw, precise=True)
    nh = kw.pop("num_heads")
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
        _close(a, b)


@pytest.mark.parametrize("C,nh,G", [(40, 4, 4), (50, 5, 5)])
@pytest.mark.parametrize("kind", ["freq", "time_key_bias"])
def test_ftf_block_matches_jax(C, nh, G, kind):
    """The FTF block: the f32 plain version against the JAX f32 reference,
    bf16 mode against the JAX Pallas kernel in interpret mode (which reads
    C, heads and groups from its shapes)."""
    x, p, kb, kw = _ftf(C, nh, G, kind, seed=1)
    jargs = [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in ORDER]
    targs = [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]
    want32 = np.asarray(jax_ftf_reference(*jargs, key_bias=_j(kb), **kw))
    got32 = ftf_block_reference(*targs, key_bias=_t(kb), precise=True,
                                **kw).numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-4)

    with pallas_override("interpret"):
        want = np.asarray(jax_ftf(*jargs, key_bias=_j(kb), block_seqs=4,
                                  sub=4, interpret=True, **kw))
    before = fused_ftf_block.launches
    got = fused_ftf_block(*targs, key_bias=_t(kb), precise=False,
                          **kw).numpy()
    assert fused_ftf_block.launches == before
    band = 2e-2 * max(1.0, np.abs(want).max() / 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=band)
    assert np.abs(got - want).mean() < 0.1 * np.abs(want32 - want).mean()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("enc,nh,G", [((16, 32, 40), 4, 4),
                                      ((16, 32, 50), 5, 5)])
def test_enhancer_matches_jax(enc, nh, G):
    """The whole LctEnhancer: the JAX package's initialised parameters
    carried across (strict=True), both all-f32 on the same waves."""
    dec = enc[::-1]
    wave = (0.1 * np.random.default_rng(enc[-1]).standard_normal(
        (1, 4000))).astype(np.float32)
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(enc_channels=enc,
                                            dec_channels=dec, num_heads=nh,
                                            gru_groups=G))
    with pallas_override(None):
        params = jax.jit(jax_enh.init)(jax.random.PRNGKey(G),
                                       jnp.asarray(wave))["params"]
        jw, jm = jax.jit(lambda w: jax_enh.apply({"params": params}, w))(
            jnp.asarray(wave))
    port = LctEnhancer(gen_cfg=LCTGeneratorConfig(
        enc_channels=enc, dec_channels=dec, num_heads=nh, gru_groups=G),
        precise=True)
    port.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        pw, pm = port(torch.from_numpy(wave))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-4)

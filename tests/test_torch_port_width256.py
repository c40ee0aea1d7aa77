"""The port at kernel width 256 (bottleneck layouts of 129 to 256 channels),
on the CPU: the FTF block, the MHSA, banded and grouped-GRU functions and
the enhancer at C = 256 against the JAX package on the same seeded numpy
inputs, the operands the CUDA wrappers hand the kernels at the layouts
padded to 256, the GRU slots and scratch the wrappers pick there, and the
build command of that width (forward sources only).

Inputs: seeded numpy as tests/test_torch_port_widths.py makes them, the
weight matrices at the scale of a fan-in init, 0.25 sqrt(64 / C) (0.125
at C = 256), so that the activations are as large as at C = 64 (the
model's own init scales with 1 / sqrt(C) too).

Tolerances, as in tests/test_torch_port_channels.py:
  f32 (precise): the port's plain version against the JAX package's f32
    reference, sum order only: 1e-4 (FTF block, enhancer), 1e-5
    (attention, GRU).
  bf16: the port's plain version against the JAX Pallas kernel in
    interpret mode (the FTF block): max |diff| <= 2e-2 per 8 of the
    output's largest magnitude (at least 2e-2), correlation > 0.99999, and
    its mean under BF16_MEAN_SHARE = a quarter of the f32 reference's
    distance from the kernel (the channels tests' tenth does not hold at
    256: a GRU step there sums up to 256 rounded products, so f32 sum
    order moves a hidden value across a bf16 rounding boundary in most of
    the 4 sequences, and the flip travels down the recurrence, moving the
    whole sequence by ~1e-3; the sequences without a flip agree to 0).
    Found on this test's inputs: max |diff| 9.5e-7 to 9.2e-3 (|out| up to
    7), the means 0.002% to 20% of the f32 distance (20% at the frequency
    block with 4 heads and 4 groups, 14% with 1 and 1, at most 1.1%
    elsewhere); f32 max |diff| at most 4.7e-6.
  The padded operands, run through the plain versions with the kernels'
    LayerNorm divisor (the true C) and score scale (the true head
    width's): 1e-5 against the unpadded block, and exactly 0 on every
    padded output channel.
On the CPU every wrapper computes its plain version and counts no launch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.models.generator import LCTGeneratorConfig as JaxConfig
from lct_gan_tpu.models.generator import LctEnhancer as JaxEnhancer
from lct_gan_tpu.ops.attention import mhsa_reference as jax_mhsa_reference
from lct_gan_tpu.ops.banded_attention import (
    banded_mhsa_reference as jax_banded_reference)
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu.ops.ftf import ftf_block_reference as jax_ftf_reference
from lct_gan_tpu.ops.ftf import fused_ftf_block as jax_ftf
from lct_gan_tpu.ops.gru import grouped_gru_reference as jax_gru
from lct_gan_tpu_torch.convert import jax_params_to_state_dict
from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer)
from lct_gan_tpu_torch.ops import _build, padding
from lct_gan_tpu_torch.ops import ftf as ftf_ops
from lct_gan_tpu_torch.ops import gru as gru_ops
from lct_gan_tpu_torch.ops.attention import (fused_mhsa, mhsa_reference,
                                             mhsa_scratch, pad_attention)
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference,
                                                    banded_scratch)
from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference, ftf_scratch,
                                       fused_ftf_block, kernel_operands)
from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru, grouped_gru_plain,
                                       gru_kernel_operands, gru_slot,
                                       gru_xp_shape, pack_gru_slots)
from lct_gan_tpu_torch.ops.library import (BACKWARD_WIDTHS, KERNEL_WIDTHS,
                                           card_takes)

from test_torch_port_channels import (_kernel_heads, _kernel_layer_norm,
                                      _padded_channels)
from test_torch_port_widths import (ORDER, _attn_params, _ftf_params, _j,
                                    _key_bias, _t)

C = 256
# (heads, groups): 4 and 4 (the main path's), one head of 256 and one
# group of 256 (the thread-block-cluster GRU), heads of 128 and groups of
# 32 (packed two to a slot of 64).
PAIRS = [(4, 4), (1, 1), (2, 8)]
# Layouts padded to kernel width 256: groups and heads of 20 (widened to
# 32), of 40 (to 64) and of 36 (to 64).
PADDED = [(100, 5, 5), (120, 3, 3), (144, 4, 4)]
KINDS = ["freq", "time_key_bias", "time_lookback"]
BF16_MEAN_SHARE = 0.25


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fan_in(p, C):
    """The weight matrices of p (a dict or list) scaled by sqrt(64 / C)."""
    f = np.float32(np.sqrt(64.0 / C))
    if isinstance(p, list):
        return [a * f if a.ndim == 2 else a for a in p]
    return {k: (a * f if k in ("w_ih", "w_hh", "in_w", "out_w", "lin_w")
                else a) for k, a in p.items()}


def _ftf_inputs(C, nh, G, kind):
    bidi = kind == "freq"
    N, L = (4, 9) if bidi else (3, 8)
    rng = np.random.default_rng(1000 * C + 10 * nh + G + len(kind))
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    p = _fan_in(_ftf_params(rng, bidi, G, C), C)
    kb = _key_bias(rng, N, L) if kind == "time_key_bias" else None
    kw = dict(bidirectional=bidi, num_heads=nh,
              lookback=3 if kind == "time_lookback" else None)
    return x, p, kb, kw


@pytest.mark.parametrize("nh,G", PAIRS)
@pytest.mark.parametrize("kind", KINDS)
def test_ftf_block_matches_jax(nh, G, kind):
    """The FTF block at C = 256: the f32 plain version against the JAX f32
    reference, bf16 mode against the JAX Pallas kernel in interpret mode
    (which reads C, heads and groups from its shapes)."""
    x, p, kb, kw = _ftf_inputs(C, nh, G, kind)
    jargs = [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in ORDER]
    targs = [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]

    want32 = np.asarray(jax_ftf_reference(*jargs, key_bias=_j(kb), **kw))
    got32 = ftf_block_reference(*targs, key_bias=_t(kb), precise=True,
                                **kw).numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-4)

    with pallas_override("interpret"):
        want = np.asarray(jax_ftf(*jargs, key_bias=_j(kb), block_seqs=8,
                                  sub=4, interpret=True, **kw))
    before = fused_ftf_block.launches
    got = fused_ftf_block(*targs, key_bias=_t(kb), precise=False,
                          **kw).numpy()
    assert fused_ftf_block.launches == before
    band = 2e-2 * max(1.0, np.abs(want).max() / 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=band)
    assert (np.abs(got - want).mean()
            < BF16_MEAN_SHARE * np.abs(want32 - want).mean())
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("nh,G", PAIRS)
def test_attention_and_gru_match_jax(nh, G):
    """MHSA with a key-masked tail, banded MHSA (S = 9, W = 3) and LN1 +
    the grouped GRU (both directions), all f32, at C = 256 against the JAX
    package."""
    rng = np.random.default_rng(C + nh + G)
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    p = _fan_in(_attn_params(rng, C), C)
    kb = _key_bias(rng, 2, 9)
    jp, tp = [jnp.asarray(a) for a in p], [torch.from_numpy(a) for a in p]
    want = np.asarray(jax_mhsa_reference(jnp.asarray(x), *jp, num_heads=nh,
                                         key_bias=_j(kb)))
    got = fused_mhsa(torch.from_numpy(x), *tp, num_heads=nh,
                     key_bias=_t(kb), precise=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    kbb = np.zeros((2, 9), np.float32)
    kbb[0, 6:] = -1e30
    want = np.asarray(jax_banded_reference(
        jnp.asarray(x), *jp, num_heads=nh, lookback=3, key_bias=_j(kbb)))
    got = banded_mhsa(torch.from_numpy(x), *tp, num_heads=nh, lookback=3,
                      key_bias=_t(kbb), precise=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    xg = rng.standard_normal((2, 7, C)).astype(np.float32)
    q = _fan_in(_ftf_params(rng, True, G, C), C)
    mu = xg.mean(-1, keepdims=True)
    var = np.maximum((xg * xg).mean(-1, keepdims=True) - mu * mu, 0.0)
    n1 = ((xg - mu) / np.sqrt(var + 1e-6) * q["ln1_scale"]
          + q["ln1_bias"]).astype(np.float32)
    gru = [q[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    want = np.asarray(jax_gru(jnp.asarray(n1), *map(jnp.asarray, gru),
                              bidirectional=True))
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(torch.from_numpy(xg), _t(q["ln1_scale"]),
                            _t(q["ln1_bias"]), *map(torch.from_numpy, gru),
                            bidirectional=True).numpy()
    assert fused_grouped_gru.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_enhancer_matches_jax():
    """The whole LctEnhancer at enc_channels (64, 128, 256), 4 heads and 4
    groups: the JAX package's initialised parameters carried across by
    jax_params_to_state_dict (strict=True), both run all-f32 on the same
    0.25 s wave."""
    enc = (64, 128, 256)
    dec = enc[::-1]
    wave = (0.1 * np.random.default_rng(256).standard_normal(
        (1, 4000))).astype(np.float32)
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(enc_channels=enc,
                                            dec_channels=dec))
    with pallas_override(None):
        params = jax.jit(jax_enh.init)(jax.random.PRNGKey(22),
                                       jnp.asarray(wave))["params"]
        jw, jm = jax.jit(lambda w: jax_enh.apply({"params": params}, w))(
            jnp.asarray(wave))
    port = LctEnhancer(gen_cfg=LCTGeneratorConfig(
        enc_channels=enc, dec_channels=dec), precise=True)
    port.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.inference_mode():
        pw, pm = port(torch.from_numpy(wave))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-4)


@pytest.mark.parametrize("C,nh,G", PADDED)
@pytest.mark.parametrize("kind", KINDS)
def test_padded_ftf_operands_are_the_same_block(monkeypatch, C, nh, G, kind):
    """What the CUDA wrapper hands the kernels at the layouts that run at
    kernel width 256 (`ops/ftf.py::kernel_operands`: channels, groups and
    heads zero-padded, the GRU packed into slots) computes the same block:
    run through the plain version with the kernels' LayerNorm divisor and
    score scale, its C true channels equal the unpadded block and every
    padded channel is exactly 0, out and hiddens alike."""
    x, p, kb, kw = _ftf_inputs(C, nh, G, kind)
    targs = [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]
    want, want_hid = ftf_block_reference(*targs, key_bias=_t(kb),
                                         precise=True, return_hidden=True,
                                         **kw)
    ops, cidx = kernel_operands([*targs, _t(kb)], nh)
    assert padding.kernel_width(C, nh, G) == 256 and ops[0].shape[-1] == 256
    nhk, ops[9], ops[10] = _kernel_heads(C, nh, ops[9], ops[10])
    monkeypatch.setattr(ftf_ops, "layer_norm", _kernel_layer_norm(C))
    got, hid = ftf_block_reference(*ops[:15], key_bias=ops[15], precise=True,
                                   return_hidden=True,
                                   **dict(kw, num_heads=nhk))
    torch.testing.assert_close(got[..., cidx], want, rtol=0, atol=1e-5)
    torch.testing.assert_close(hid[..., cidx], want_hid, rtol=0, atol=1e-5)
    pad = _padded_channels(cidx, 256)
    assert got[..., pad].abs().max() == 0 and hid[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,nh,G", PADDED)
def test_padded_attention_and_gru_operands(monkeypatch, C, nh, G):
    """The same for the MHSA and banded wrappers (`pad_attention`) and the
    composed GRU's (`gru_kernel_operands`) at those layouts, each at its
    own kernel width (heads alone: 256 at all three; groups alone: 256 at
    5 and 3 groups, 256 at 4 groups of 36)."""
    rng = np.random.default_rng(C * nh + G)
    x = torch.from_numpy(rng.standard_normal((2, 9, C)).astype(np.float32))
    p = [torch.from_numpy(a) for a in _fan_in(_attn_params(rng, C), C)]
    kb = torch.from_numpy(_key_bias(rng, 2, 9))
    for ref, kw in ((mhsa_reference, {}),
                    (banded_mhsa_reference, {"lookback": 3})):
        want = ref(x, *p, num_heads=nh, key_bias=kb, precise=True, **kw)
        ops, padded = pad_attention([x, *p, kb], nh)
        assert padded and ops[0].shape[-1] == 256
        nhk, ops[1], ops[2] = _kernel_heads(C, nh, ops[1], ops[2])
        got = ref(*ops[:5], num_heads=nhk, key_bias=ops[5], precise=True,
                  **kw)
        torch.testing.assert_close(got[..., :C], want, rtol=0, atol=1e-5)
        assert got[..., C:].abs().max() == 0

    q = {k: torch.from_numpy(v)
         for k, v in _fan_in(_ftf_params(rng, True, G, C), C).items()}
    gru = [q[k] for k in ("ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih",
                          "b_hh")]
    want = grouped_gru_plain(x, *gru, True)
    ops, idx = gru_kernel_operands([x, *gru])
    CG = padding.kernel_width(C, groups=G)
    assert ops[0].shape[-1] == CG == 256
    monkeypatch.setattr(gru_ops, "layer_norm", _kernel_layer_norm(C))
    got = gru_ops.grouped_gru_plain(*ops, True)
    torch.testing.assert_close(got[..., idx], want, rtol=0, atol=1e-5)
    assert got[..., _padded_channels(idx, CG)].abs().max() == 0


@pytest.mark.parametrize("G,slot", [(16, 16), (32, 16), (8, 64), (4, 64),
                                    (2, 128), (1, 256)])
def test_gru_slots_at_256(G, slot):
    """The FTF kernels' GRU slots at kernel width 256: 16 units (groups of
    16 or fewer), 64 (groups of 32, two to a slot, and of 64), 128, and one
    slot of 256 (the thread-block-cluster kernel's); packing into them is
    exact on the grouped GRU. The composed GRU's xp scratch exists for one
    group of 256 alone."""
    assert gru_slot(G, C) == slot
    rng = np.random.default_rng(G)
    H = C // G
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
         for s in ((1, G, H, 3 * H), (1, G, H, 3 * H), (1, G, 3 * H),
                   (1, G, 3 * H))]
    packed = pack_gru_slots(*w)
    assert tuple(packed[0].shape) == (1, C // slot, slot, 3 * slot)
    x = torch.from_numpy(rng.standard_normal((2, 5, C)).astype(np.float32))
    torch.testing.assert_close(
        gru_ops.grouped_gru(x, *packed, bidirectional=False),
        gru_ops.grouped_gru(x, *w, bidirectional=False), rtol=0, atol=1e-5)
    assert gru_xp_shape(45, 2, C, G) == ((45, 6 * C) if G == 1 else None)
    assert gru_xp_shape(45, 2, 128, 1) is None


@pytest.mark.parametrize("precise", [False, True])
def test_scratch_at_256(precise):
    """The wrappers' scratch at kernel width 256: bf16 adds the attention's
    context as bf16 (the split epilogue reads it) to every kernel, and the
    FTF block's GRU input projection wherever its slots are wider than 16
    (CUDA cores, or the cluster kernel); precise is what it is at every
    width."""
    rows = 100
    ctx = ("ctx", (rows, C), torch.bfloat16)
    qkv = ("qkv", (rows, 3 * C), torch.bfloat16)
    if precise:
        f32 = [("qkv", (rows, 3 * C), torch.float32),
               ("ctx", (rows, C), torch.float32)]
        assert mhsa_scratch(rows, True, C) == f32
        assert banded_scratch(rows, True, False, C) == f32
        assert ftf_scratch(rows, 2, 2 * C, True, C, 4)[2:] == f32
        return
    assert mhsa_scratch(rows, False, C) == [qkv, ctx]
    assert banded_scratch(rows, False, False, C) == [qkv, ctx]
    assert mhsa_scratch(rows, False, 128) == [
        ("qkv", (rows, 384), torch.bfloat16)]
    xp = ("xp", (rows, 6 * C), torch.float32)
    for slots, want_xp in ((16, None), (4, xp), (2, xp), (1, xp)):
        got = ftf_scratch(rows, 2, 2 * C, False, C, slots)
        assert len(got) == 6 and got[4] == want_xp and got[5] == ctx
        assert got[3] == ("gb", (rows, C), torch.bfloat16)
    assert ftf_scratch(rows, 1, C, False, C, 16)[3] is None


def test_build_command_at_256():
    """Kernel width 256 builds the forward sources with -DLCT_C=256 into a
    library of its own, and at the first backward the FTF backward's
    (csrc/ftf_bwd.cu) beside them; the backward past 512 is refused by
    name (512 builds its own since the backward took that width), and any
    width past 512 for the forward too. The card trains and serves layouts
    up to 512 channels."""
    assert KERNEL_WIDTHS[-1] == 512 and BACKWARD_WIDTHS[-1] == 512
    assert _build.library_sources(256) == ["banded", "ftf", "mhsa"]
    assert _build.library_sources(256, backward=True) == [
        "banded", "ftf", "ftf_bwd", "mhsa"]
    for name in ("ftf", "ftf_bwd"):
        cmd = _build.build_command(name, 256, "o.so", "nvcc")
        assert "-DLCT_C=256" in cmd and cmd[-1].endswith(f"/{name}.cu")
    assert _build.library_path("mhsa", 256, "t").endswith("/libmhsa-c256-t.so")
    assert _build.library_path("ftf_bwd", 256, "t").endswith(
        "/libftf_bwd-c256-t.so")
    assert _build.library_sources(512, backward=True) == [
        "banded", "ftf", "ftf_bwd", "mhsa"]
    for backward in (False, True):
        with pytest.raises(ValueError, match="C=1024"):
            _build.library_sources(1024, backward=backward)
    for c, nh, G in [(256, 4, 4), (256, 1, 1), (256, 2, 8), *PADDED]:
        assert card_takes(c, nh, G) and card_takes(c, nh, G, True)
    assert card_takes(272, 1, 1) and card_takes(272, 1, 1, True)
    assert not card_takes(544, 1, 1) and not card_takes(544, 1, 1, True)

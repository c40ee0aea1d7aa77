"""The port at kernel width 512 (bottleneck layouts of 257 to 512 channels,
served and trained on the card), on the CPU: the FTF
block, the MHSA, banded and grouped-GRU functions and the enhancer at
C = 512 against the JAX package on the same seeded numpy inputs, the
operands the CUDA wrappers hand the kernels at the layouts padded to 512,
the GRU slots and scratch the wrappers pick there, the build command of
that width (the forward sources, and the backward's at the first
backward), and the card's widths: taken up to 512 for serving and
training alike, refused by name past them.

Inputs: seeded numpy as tests/test_torch_port_width256.py makes them, the
weight matrices at the scale of a fan-in init, 0.25 sqrt(64 / C) (0.088
at C = 512), so that the activations are as large as at C = 64.

Tolerances, width 256's (tests/test_torch_port_width256.py):
  f32 (precise): the port's plain version against the JAX package's f32
    reference, sum order only: 1e-4 (FTF block, enhancer), 1e-5
    (attention, GRU).
  bf16: the port's plain version against the JAX Pallas kernel in
    interpret mode (the FTF block): max |diff| <= 2e-2 per 8 of the
    output's largest magnitude (at least 2e-2), correlation > 0.99999, and
    its mean under BF16_MEAN_SHARE, a quarter of the f32 reference's
    distance from the kernel, or else at most half the kernel's distance
    from the same bf16 arithmetic with its sums taken in f64 (the port's
    plain version on f64 tensors: the roundings of the contract, sums
    exact to f32). That second branch is what the one group and head of
    512 take: a GRU step and a score there sum 512 rounded products, and
    the f32 sums of the JAX kernel in interpret mode move a value across a
    bf16 rounding boundary in most sequences (the flip travels down the
    recurrence), more often than the port's. Found on this test's inputs
    at (1, 1): the port 0.00097-0.0010 from the kernel (0.25-0.33 of the
    f32 distance), 1.1e-5 to 1.7e-4 from the f64-summed version, the
    kernel 0.00097-0.0010 from it; the sequences without a flip agree to
    1.2e-7. At (4, 4) the first branch holds.
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
                                                LctEnhancer,
                                                check_card_widths)
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
from test_torch_port_width256 import BF16_MEAN_SHARE, KINDS, _fan_in

C = 512
# (heads, groups): 4 and 4 (the main path's at this width: heads and slots
# of 128), one head of 512 and one group of 512 (the step GRU).
PAIRS = [(4, 4), (1, 1)]
# Layouts padded to kernel width 512: a head and a group of 272 (widened to
# 512), heads and groups of 100 (to 128) and of 64 (five of them: 320
# channels, past 256).
PADDED = [(272, 1, 1), (300, 3, 3), (320, 5, 5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The FTF block at C = 512: the f32 plain version against the JAX f32
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
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    mean = np.abs(got - want).mean()
    if mean >= BF16_MEAN_SHARE * np.abs(want32 - want).mean():
        got64 = ftf_block_reference(
            *(t.double() for t in targs),
            key_bias=None if kb is None else _t(kb).double(), precise=False,
            **kw).float().numpy()
        assert (np.abs(got - got64).mean()
                <= 0.5 * np.abs(want - got64).mean()), (
            mean, np.abs(want32 - want).mean(), np.abs(got - got64).mean(),
            np.abs(want - got64).mean())


@pytest.mark.parametrize("nh,G", PAIRS)
def test_attention_and_gru_match_jax(nh, G):
    """MHSA with a key-masked tail, banded MHSA (S = 9, W = 3) and LN1 +
    the grouped GRU (both directions), all f32, at C = 512 against the JAX
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
    """The whole LctEnhancer at enc_channels (128, 256, 512), 4 heads and
    4 groups: the JAX package's initialised parameters carried across by
    jax_params_to_state_dict (strict=True), both run all-f32 on the same
    0.25 s wave."""
    enc = (128, 256, 512)
    dec = enc[::-1]
    wave = (0.1 * np.random.default_rng(512).standard_normal(
        (1, 4000))).astype(np.float32)
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(enc_channels=enc,
                                            dec_channels=dec))
    with pallas_override(None):
        params = jax.jit(jax_enh.init)(jax.random.PRNGKey(24),
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
@pytest.mark.parametrize("kind", ["freq", "time_key_bias"])
def test_padded_ftf_operands_are_the_same_block(monkeypatch, C, nh, G, kind):
    """What the CUDA wrapper hands the kernels at the layouts that run at
    kernel width 512 (`ops/ftf.py::kernel_operands`: channels, groups and
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
    assert padding.kernel_width(C, nh, G) == 512 and ops[0].shape[-1] == 512
    nhk, ops[9], ops[10] = _kernel_heads(C, nh, ops[9], ops[10])
    monkeypatch.setattr(ftf_ops, "layer_norm", _kernel_layer_norm(C))
    got, hid = ftf_block_reference(*ops[:15], key_bias=ops[15], precise=True,
                                   return_hidden=True,
                                   **dict(kw, num_heads=nhk))
    torch.testing.assert_close(got[..., cidx], want, rtol=0, atol=1e-5)
    torch.testing.assert_close(hid[..., cidx], want_hid, rtol=0, atol=1e-5)
    pad = _padded_channels(cidx, 512)
    assert got[..., pad].abs().max() == 0 and hid[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,nh,G", PADDED)
def test_padded_attention_and_gru_operands(monkeypatch, C, nh, G):
    """The same for the MHSA and banded wrappers (`pad_attention`) and the
    composed GRU's (`gru_kernel_operands`) at those layouts, each at its
    own kernel width (heads alone and groups alone: 512 at all three)."""
    rng = np.random.default_rng(C * nh + G)
    x = torch.from_numpy(rng.standard_normal((2, 9, C)).astype(np.float32))
    p = [torch.from_numpy(a) for a in _fan_in(_attn_params(rng, C), C)]
    kb = torch.from_numpy(_key_bias(rng, 2, 9))
    for ref, kw in ((mhsa_reference, {}),
                    (banded_mhsa_reference, {"lookback": 3})):
        want = ref(x, *p, num_heads=nh, key_bias=kb, precise=True, **kw)
        ops, padded = pad_attention([x, *p, kb], nh)
        assert padded and ops[0].shape[-1] == 512
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
    assert ops[0].shape[-1] == CG == 512
    monkeypatch.setattr(gru_ops, "layer_norm", _kernel_layer_norm(C))
    got = gru_ops.grouped_gru_plain(*ops, True)
    torch.testing.assert_close(got[..., idx], want, rtol=0, atol=1e-5)
    assert got[..., _padded_channels(idx, CG)].abs().max() == 0


@pytest.mark.parametrize("G,slot", [(64, 16), (32, 16), (16, 64), (8, 64),
                                    (4, 128), (2, 256), (1, 512)])
def test_gru_slots_at_512(G, slot):
    """The FTF kernels' GRU slots at kernel width 512: 16 units (groups of
    16 or fewer), 64 (groups of 32, two to a slot, and of 64), 128, 256
    (the thread-block-cluster kernel's) and one slot of 512 (the step
    kernel's); packing into them is exact on the grouped GRU. The composed
    GRU's xp scratch exists for groups of 256 and 512 alone."""
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
    assert gru_xp_shape(45, 2, C, G) == ((45, 6 * C) if G <= 2 else None)
    assert gru_xp_shape(45, 2, 256, 2) is None


def test_xp_scratch_at_the_frequency_main_shape():
    """The xp scratch of C = 512's groups of 256 and 512 at the frequency
    block's main shape (B = 128 x 2 s: 16,512 sequences of 33, two
    directions): 544,896 rows of 3,072 f32, 6.7 GB, for the composed GRU
    and the FTF block's bf16 GRU alike."""
    rows = 16512 * 33
    for G in (1, 2):
        shape = gru_xp_shape(rows, 2, C, G)
        assert shape == (rows, 6 * C)
        assert abs(4 * shape[0] * shape[1] - 6.7e9) < 0.05e9
        assert ftf_scratch(rows, 2, 2 * C, False, C, G)[4] == (
            "xp", shape, torch.float32)


@pytest.mark.parametrize("precise", [False, True])
def test_scratch_at_512(precise):
    """The wrappers' scratch at kernel width 512, as at 256: bf16 adds the
    attention's context as bf16 (the split epilogue reads it) to every
    kernel, and the FTF block's GRU input projection wherever its slots are
    wider than 16 (CUDA cores, the cluster and the step kernels); precise
    is what it is at every width."""
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
    assert banded_scratch(rows, False, True, C) == []
    xp = ("xp", (rows, 6 * C), torch.float32)
    for slots, want_xp in ((32, None), (8, xp), (4, xp), (2, xp), (1, xp)):
        got = ftf_scratch(rows, 2, 2 * C, False, C, slots)
        assert len(got) == 6 and got[4] == want_xp and got[5] == ctx
        assert got[3] == ("gb", (rows, C), torch.bfloat16)
    assert ftf_scratch(rows, 1, C, False, C, 32)[3] is None


def test_build_command_at_512():
    """Kernel width 512 builds the forward sources alone with -DLCT_C=512
    into libraries of its own, and its FTF backward (csrc/ftf_bwd.cu)
    beside them at the first backward; any width past 512 is refused by
    name."""
    assert KERNEL_WIDTHS[-1] == 512 and BACKWARD_WIDTHS[-1] == 512
    assert 512 in BACKWARD_WIDTHS
    assert _build.library_sources(512) == ["banded", "ftf", "mhsa"]
    assert _build.library_sources(512, backward=True) == [
        "banded", "ftf", "ftf_bwd", "mhsa"]
    with pytest.raises(ValueError, match=r"C=1024.*\(16, 32, 64, "
                                         r"128, 256, 512\)"):
        _build.library_sources(1024, backward=True)
    for name in ("banded", "ftf", "mhsa"):
        cmd = _build.build_command(name, 512, "o.so", "nvcc")
        assert "-DLCT_C=512" in cmd and cmd[-1].endswith(f"/{name}.cu")
    assert _build.library_path("ftf", 512, "t").endswith("/libftf-c512-t.so")
    with pytest.raises(ValueError, match="C=1024"):
        _build.library_sources(1024)


def _cfg(enc, nh=4, G=4):
    return LCTGeneratorConfig(enc_channels=enc, dec_channels=enc[::-1],
                              num_heads=nh, gru_groups=G)


@pytest.mark.parametrize("C,nh,G", [(512, 1, 1), (512, 4, 4), (512, 2, 2),
                                    (512, 64, 64), *PADDED])
def test_card_serves_layouts_up_to_512(C, nh, G):
    """The card serves and trains every layout whose padded width fits
    512 channels and refuses to train the same heads and groups at twice
    the channels, past 512, naming enc_channels, the flags and the
    backward's width, before a model runs; the CPU takes them all."""
    assert card_takes(C, nh, G) and card_takes(C, nh, G, True)
    check_card_widths(_cfg((64, 128, C), nh, G), "cuda", training=False)
    check_card_widths(_cfg((64, 128, C), nh, G), "cuda", training=True)
    need = padding.layout_width(2 * C, nh, G)
    with pytest.raises(ValueError, match=(
            rf"^the CUDA path takes widths whose padded layout fits 512 "
            rf"channels, got enc_channels\[-1\]={2 * C}, --num_heads {nh}, "
            rf"--gru_groups {G}: the padded layout needs {need} channels "
            rf"\(> 512\); train this configuration with --device cpu")):
        check_card_widths(_cfg((64, 128, 2 * C), nh, G), "cuda",
                          training=True)
    check_card_widths(_cfg((64, 128, 2 * C), nh, G), "cpu", training=True)


@pytest.mark.parametrize("enc,nh,G,need", [((64, 128, 520), 4, 4, 1024),
                                           ((64, 128, 400), 5, 5, 640),
                                           ((128, 256, 576), 1, 1, 1024)])
def test_card_refuses_serving_past_512_by_name(enc, nh, G, need):
    """Serving past 512 channels is refused by name before any launch:
    (64, 128, 520), and (400, 5, 5), whose heads of 80 need a layout of
    640; the CPU serves them."""
    C = enc[-1]
    assert not card_takes(C, nh, G)
    with pytest.raises(ValueError, match=(
            rf"^the CUDA path takes widths whose padded layout fits 512 "
            rf"channels, got enc_channels\[-1\]={C}, --num_heads {nh}, "
            rf"--gru_groups {G}: the padded layout needs {need} channels "
            rf"\(> 512\); run this configuration with device='cpu'")):
        check_card_widths(_cfg(enc, nh, G), "cuda", training=False)
    check_card_widths(_cfg(enc, nh, G), "cpu", training=False)

"""The port at generator widths other than 4 heads and 4 GRU groups, on the
CPU: each module that holds a kernel and the whole enhancer against the
JAX package on the same seeded numpy inputs, at (num_heads, gru_groups) in
{(1, 1), (2, 2), (8, 8), (16, 64)} (C = 64: heads of 64 .. 4 channels,
groups of 64 .. 1 unit), and the width checks the card's entry points make.

Tolerances, as in test_torch_port_ftf.py / _attention.py / _banded.py:
  f32 (precise): the port's plain version against the JAX package's f32
    reference, sum order only: 1e-4 (FTF block, enhancer), 1e-5
    (attention, GRU).
  bf16: the port's plain version rounds every GEMM operand where the TPU
    kernel does, so it tracks the JAX Pallas kernel in interpret mode far
    inside the kernel-vs-f32 band; what remains is f32 sum order moving a
    value across a bf16 rounding boundary. The FTF block at these widths:
    max |diff| <= 2e-2 (found 5e-7 .. 1.3e-2; wider GRU groups and heads
    sum more rounded products into each value, and a flip in a hidden state
    travels down the recurrence: 2.3e-4 .. 2.9e-3 at 4 and 4, on the same
    inputs), its mean under a tenth of the f32 reference's distance from
    the kernel (found <= 0.053), correlation > 0.99999.
On the CPU every wrapper computes its plain version and counts no launch."""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.models.generator import LCTGeneratorConfig as JaxConfig
from lct_gan_tpu.models.generator import LctEnhancer as JaxEnhancer
from lct_gan_tpu.ops.attention import fused_mhsa as jax_mhsa
from lct_gan_tpu.ops.attention import mhsa_reference as jax_mhsa_reference
from lct_gan_tpu.ops.banded_attention import banded_mhsa as jax_banded
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
from lct_gan_tpu_torch.ops import _build
from lct_gan_tpu_torch.ops.attention import (_MHSA_ARGTYPES,
                                             check_attention_shapes,
                                             fused_mhsa, mhsa_reference)
from lct_gan_tpu_torch.ops.banded_attention import (BANDED_ENTRY,
                                                    banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import (_FTF_ARGTYPES, check_kernel_shapes,
                                       ftf_block_reference, fused_ftf_block)
from lct_gan_tpu_torch.ops.ftf_bwd import _BWD_ARGTYPES, check_backward_shapes
from lct_gan_tpu_torch.ops.gru import (_GRU_ARGTYPES, _check_gru_shapes,
                                       fused_grouped_gru, grouped_gru,
                                       gru_slot, pack_gru_slots)
from lct_gan_tpu_torch.ops.library import divisors
from lct_gan_tpu_torch.train.state import TrainConfig, create_state

WIDTHS = [(1, 1), (2, 2), (8, 8), (16, 64)]
KERNEL_WIDTHS = divisors(64)   # the head and group counts at C = 64
ORDER = ("ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih", "b_hh",
         "ln2_scale", "ln2_bias", "in_w", "in_b", "out_w", "out_b",
         "lin_w", "lin_b")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ftf_params(rng, bidirectional, G, C=64):
    D = 2 if bidirectional else 1
    H = C // G

    def u(shape, b=0.25):
        return rng.uniform(-b, b, shape).astype(np.float32)

    return dict(
        ln1_scale=1.0 + 0.1 * u((C,)), ln1_bias=0.1 * u((C,)),
        w_ih=u((D, G, H, 3 * H)), w_hh=u((D, G, H, 3 * H)),
        b_ih=u((D, G, 3 * H)), b_hh=u((D, G, 3 * H)),
        ln2_scale=1.0 + 0.1 * u((C,)), ln2_bias=0.1 * u((C,)),
        in_w=u((C, 3 * C)), in_b=0.1 * u((3 * C,)),
        out_w=u((C, C)), out_b=0.1 * u((C,)),
        lin_w=u(((2 * C if bidirectional else C), C)), lin_b=0.1 * u((C,)))


def _key_bias(rng, N, L):
    valid = rng.integers(L // 2, L + 1, size=N)
    return np.where(np.arange(L)[None, :] < valid[:, None], 0.0,
                    -1e30).astype(np.float32)


def _attn_params(rng, C=64):
    return [rng.uniform(-0.25, 0.25, s).astype(np.float32)
            for s in ((C, 3 * C), (3 * C,), (C, C), (C,))]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("nh,G", WIDTHS)
@pytest.mark.parametrize("kind", ["freq", "time_key_bias", "time_lookback"])
def test_ftf_block_matches_jax(nh, G, kind):
    """The FTF block (the bidirectional frequency block; the causal time
    block with a key-masked tail, or with a band of 7): the f32 plain
    version against the JAX f32 reference, and bf16 mode against the JAX
    Pallas kernel in interpret mode. The tail and the band are apart
    because together they leave rows whose whole band is key-masked,
    where the JAX kernel's -1e30 mask and its own reference's -inf differ
    at every width."""
    bidi = kind == "freq"
    N, L = (12, 17) if bidi else (6, 40)
    rng = np.random.default_rng(100 * nh + G)
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    p = _ftf_params(rng, bidi, G)
    kb = _key_bias(rng, N, L) if kind == "time_key_bias" else None
    lookback = 7 if kind == "time_lookback" else None
    kw = dict(bidirectional=bidi, num_heads=nh, lookback=lookback)
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
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.abs(got - want).mean() < 0.1 * np.abs(want32 - want).mean()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("nh,G", WIDTHS)
def test_mhsa_matches_jax(nh, G):
    """MHSA with a key-masked tail: f32 against the JAX reference, bf16
    against the interpret-mode kernel (nearer it than f32 is)."""
    rng = np.random.default_rng(nh)
    N, L = 6, 24
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    p = _attn_params(rng)
    kb = _key_bias(rng, N, L)
    jp, tp = [jnp.asarray(a) for a in p], [torch.from_numpy(a) for a in p]
    want32 = np.asarray(jax_mhsa_reference(jnp.asarray(x), *jp, num_heads=nh,
                                           key_bias=_j(kb)))
    got32 = mhsa_reference(torch.from_numpy(x), *tp, num_heads=nh,
                           key_bias=_t(kb)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
    with pallas_override("interpret"):
        want = np.asarray(jax_mhsa(jnp.asarray(x), *jp, num_heads=nh,
                                   key_bias=_j(kb), block_seqs=2,
                                   interpret=True))
    before = fused_mhsa.launches
    got = fused_mhsa(torch.from_numpy(x), *tp, num_heads=nh, key_bias=_t(kb),
                     precise=False).numpy()
    assert fused_mhsa.launches == before
    err, err32 = np.abs(got - want), np.abs(got32 - want)
    assert err.max() < 2e-3 and err.max() < 0.5 * err32.max()
    assert err.mean() < 0.1 * err32.mean()


@pytest.mark.parametrize("nh,G", WIDTHS)
def test_banded_matches_jax(nh, G):
    """Banded MHSA (S = 200, W = 32, a padded tail on row 0): f32 against
    the JAX reference, bf16 against the interpret-mode kernel."""
    rng = np.random.default_rng(10 + nh)
    B, S, W = 2, 200, 32
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    p = [(0.1 * a).astype(np.float32) for a in _attn_params(rng)]
    kb = np.zeros((B, S), np.float32)
    kb[0, S - 9:] = -1e30
    jp, tp = [jnp.asarray(a) for a in p], [torch.from_numpy(a) for a in p]
    want32 = np.asarray(jax_banded_reference(
        jnp.asarray(x), *jp, num_heads=nh, lookback=W, key_bias=_j(kb)))
    got32 = banded_mhsa_reference(torch.from_numpy(x), *tp, num_heads=nh,
                                  lookback=W, key_bias=_t(kb)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
    with pallas_override("interpret"):
        want = np.asarray(jax_banded(jnp.asarray(x), *jp, num_heads=nh,
                                     lookback=W, key_bias=_j(kb),
                                     interpret=True))
    before = banded_mhsa.launches
    got = banded_mhsa(torch.from_numpy(x), *tp, num_heads=nh, lookback=W,
                      key_bias=_t(kb), precise=False).numpy()
    assert banded_mhsa.launches == before
    err, err32 = np.abs(got - want), np.abs(got32 - want)
    assert err.max() < 2e-3 and err.max() < 0.5 * err32.max()
    assert err.mean() < 0.1 * err32.mean()


@pytest.mark.parametrize("nh,G", WIDTHS)
def test_grouped_gru_matches_jax(nh, G):
    """LN1 and the grouped GRU of the composed time block (all f32, both
    directions) against the JAX package's grouped GRU on the same LN1."""
    rng = np.random.default_rng(20 + G)
    N, L = 3, 30
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    p = _ftf_params(rng, True, G)
    mu = x.mean(-1, keepdims=True)
    var = np.maximum((x * x).mean(-1, keepdims=True) - mu * mu, 0.0)
    n1 = ((x - mu) / np.sqrt(var + 1e-6) * p["ln1_scale"]
          + p["ln1_bias"]).astype(np.float32)
    gru = [p[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    want = np.asarray(jax_gru(jnp.asarray(n1), *map(jnp.asarray, gru),
                              bidirectional=True))
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(torch.from_numpy(x), _t(p["ln1_scale"]),
                            _t(p["ln1_bias"]), *map(torch.from_numpy, gru),
                            bidirectional=True).numpy()
    assert fused_grouped_gru.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("G", KERNEL_WIDTHS)
def test_packed_gru_slots_compute_the_same_gru(G):
    """The weights the CUDA wrappers hand the GRU kernels: G groups packed
    block-diagonally into 4 slots of 16 units or 1 of 64 run the same GRU
    (the zeros off the blocks add nothing; only sum order may differ)."""
    rng = np.random.default_rng(40 + G)
    H, W = 64 // G, gru_slot(G)
    gru = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
           for s in ((2, G, H, 3 * H), (2, G, H, 3 * H), (2, G, 3 * H),
                     (2, G, 3 * H))]
    packed = pack_gru_slots(*gru)
    assert [tuple(t.shape) for t in packed] == [
        (2, 64 // W, W, 3 * W), (2, 64 // W, W, 3 * W), (2, 64 // W, 3 * W),
        (2, 64 // W, 3 * W)]
    if H == W:
        assert all(p is t for p, t in zip(packed, gru))
    x = torch.from_numpy(rng.standard_normal((3, 7, 64)).astype(np.float32))
    want = grouped_gru(x, *gru, bidirectional=True)
    got = grouped_gru(x, *packed, bidirectional=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nh,G", [(8, 8), (2, 2)])
def test_enhancer_matches_jax(nh, G):
    """The whole LctEnhancer at these widths: the JAX package's initialised
    parameters carried across by jax_params_to_state_dict (strict=True:
    G groups of 64 / G per block) and both run all-f32 (the JAX jnp path,
    the port's plain path with precise=True) on the same waves."""
    wave = (0.1 * np.random.default_rng(G).standard_normal((2, 6000))
            ).astype(np.float32)
    jax_enh = JaxEnhancer(gen_cfg=JaxConfig(num_heads=nh, gru_groups=G))
    with pallas_override(None):
        params = jax.jit(jax_enh.init)(jax.random.PRNGKey(G),
                                       jnp.asarray(wave))["params"]
        jw, jm = jax.jit(lambda w: jax_enh.apply({"params": params}, w))(
            jnp.asarray(wave))
    port = LctEnhancer(gen_cfg=LCTGeneratorConfig(num_heads=nh,
                                                  gru_groups=G),
                       precise=True)
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    port.load_state_dict(sd, strict=True)
    gen = port.gen
    H = 64 // G
    assert all(getattr(b, f"gru{G}").weight_hh_l0.shape == (3 * H, H)
               for b in (gen.GRUf1, gen.GRUt1, gen.GRUf2))
    with torch.inference_mode():
        pw, pm = port(torch.from_numpy(wave))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-4)


def test_kernel_checks_take_every_divisor_pair():
    """The forward kernels' checks take every (heads, groups) pair of
    divisors of 64 at C = 64, and refuse other counts and widths whose
    padded layout passes 512 channels (576 in 4 heads or groups; 48 and 40
    are taken since the kernels take the true width at run time, 144 since
    they take layouts up to 256 channels, 288 since they take them up to
    512)."""
    x = torch.zeros((2, 5, 64))
    for G in KERNEL_WIDTHS:
        H = 64 // G
        w_ih = torch.zeros((2, G, H, 3 * H))
        _check_gru_shapes(x, w_ih)
        for nh in KERNEL_WIDTHS:
            check_kernel_shapes("f", x, w_ih, torch.zeros((128, 64)), nh,
                                True)
            check_attention_shapes("a", x, nh, 1024)
    with pytest.raises(ValueError, match="num_heads"):
        check_attention_shapes("a", x, 3)
    with pytest.raises(ValueError, match="GRU groups"):
        _check_gru_shapes(x, torch.zeros((1, 3, 21, 63)))
    check_attention_shapes("a", torch.zeros((2, 5, 48)), 4)
    _check_gru_shapes(torch.zeros((2, 5, 48)), torch.zeros((1, 4, 12, 36)))
    check_attention_shapes("a", torch.zeros((2, 5, 40)), 4)
    _check_gru_shapes(torch.zeros((2, 5, 40)), torch.zeros((1, 4, 10, 30)))
    check_attention_shapes("a", torch.zeros((2, 5, 144)), 4)
    _check_gru_shapes(torch.zeros((2, 5, 144)), torch.zeros((1, 4, 36, 108)))
    check_attention_shapes("a", torch.zeros((2, 5, 288)), 4)
    _check_gru_shapes(torch.zeros((2, 5, 288)), torch.zeros((1, 4, 72, 216)))
    with pytest.raises(ValueError, match="got E=576"):
        check_attention_shapes("a", torch.zeros((2, 5, 576)), 4)
    with pytest.raises(ValueError, match="got C=576"):
        _check_gru_shapes(torch.zeros((2, 5, 576)),
                          torch.zeros((1, 4, 144, 432)))


def test_backward_check_takes_only_4_heads_and_4_groups():
    """The backward kernel's check now takes every (heads, groups) pair of
    divisors of 64 at C = 64, as the forward's, and refuses 3 heads or 3
    groups (the name is kept from when it took 4 and 4 alone)."""
    x, lin_w = torch.zeros((2, 5, 64)), torch.zeros((128, 64))
    for G in KERNEL_WIDTHS:
        H = 64 // G
        for nh in KERNEL_WIDTHS:
            check_backward_shapes("b", x, torch.zeros((2, G, H, 3 * H)),
                                  lin_w, nh, True)
    with pytest.raises(ValueError, match="num_heads"):
        check_backward_shapes("b", x, torch.zeros((2, 4, 16, 48)), lin_w, 3,
                              True)
    with pytest.raises(ValueError, match="GRU groups"):
        check_backward_shapes("b", x, torch.zeros((2, 3, 21, 63)), lin_w, 4,
                              True)


@pytest.mark.parametrize("training", [False, True])
def test_c48_is_refused_on_the_card_naming_enc_channels(training):
    """C = 48 was refused on the card while a kernel lacked that width (the
    name is kept from then); serving and training both take it, and 40,
    now that the kernels take the true width at run time, and C = 144
    (its padded layout, 256 channels, fits the widest kernel, forward and
    backward alike) and C = 288 (its layout of 512 fits the widest, 512,
    for training since the backward took that width), and refuse instead,
    naming enc_channels, C = 576 (past 512) for both."""
    cfg = LCTGeneratorConfig(enc_channels=(16, 32, 48),
                             dec_channels=(48, 32, 16))
    c40 = LCTGeneratorConfig(enc_channels=(16, 32, 40),
                             dec_channels=(40, 32, 16))
    c144 = LCTGeneratorConfig(enc_channels=(16, 32, 144),
                              dec_channels=(144, 32, 16))
    c288 = LCTGeneratorConfig(enc_channels=(16, 32, 288),
                              dec_channels=(288, 32, 16))
    c576 = LCTGeneratorConfig(enc_channels=(16, 32, 576),
                              dec_channels=(576, 32, 16))
    refused = c576
    with pytest.raises(ValueError, match=r"enc_channels"):
        check_card_widths(refused, "cuda", training=training)
    check_card_widths(c288, "cuda", training=training)
    check_card_widths(cfg, "cuda", training=training)
    check_card_widths(c40, "cuda", training=training)
    check_card_widths(c144, "cuda", training=training)
    check_card_widths(refused, "cpu", training=training)  # the plain path


def test_card_widths_are_decided_from_the_device_argument():
    """Serving and training on the card take every divisor pair; the CPU
    takes everything; 3 groups or 3 heads is refused on the card for both,
    naming the flag. No card is queried."""
    for nh in KERNEL_WIDTHS:
        for G in KERNEL_WIDTHS:
            cfg = LCTGeneratorConfig(num_heads=nh, gru_groups=G)
            check_card_widths(cfg, torch.device("cuda", 0), training=False)
            check_card_widths(cfg, "cpu", training=True)
            check_card_widths(cfg, "cuda", training=True)
            check_card_widths(cfg, "cuda:0", training=True)
    for training in (False, True):
        with pytest.raises(ValueError, match="--gru_groups"):
            check_card_widths(LCTGeneratorConfig(gru_groups=3), "cuda",
                              training=training)
        with pytest.raises(ValueError, match="--num_heads"):
            check_card_widths(LCTGeneratorConfig(num_heads=3), "cuda:0",
                              training=training)


def test_training_state_refuses_other_widths_before_the_card():
    """create_state at (2, 2) on "cuda" raises no width error: it gets as
    far as the device, where this machine's missing GPU stops it (on a
    machine with a card it trains). 3 groups is still refused on the
    device argument alone, before the card, naming the flag."""
    with pytest.raises(RuntimeError, match="no CUDA GPU is visible"):
        create_state(TrainConfig(num_heads=2, gru_groups=2), device="cuda")
    with pytest.raises(ValueError, match="--gru_groups"):
        create_state(TrainConfig(num_heads=2, gru_groups=3), device="cuda")


def _c_params(source):
    """{name: parameter count} of the extern "C" int functions of csrc/."""
    with open(os.path.join(_build.CSRC_DIR, source), encoding="utf-8") as f:
        src = f.read()
    return {name: len([a for a in args.split(",") if a.strip()])
            for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         src)}


@pytest.mark.parametrize("source,entry,argtypes", [
    ("ftf.cu", "lct_ftf_forward_bf16", _FTF_ARGTYPES[False]),
    ("ftf.cu", "lct_ftf_forward_f32", _FTF_ARGTYPES[True]),
    ("ftf.cu", "lct_grouped_gru_f32", _GRU_ARGTYPES),
    ("mhsa.cu", "lct_mhsa_forward_bf16", _MHSA_ARGTYPES[False]),
    ("mhsa.cu", "lct_mhsa_forward_f32", _MHSA_ARGTYPES[True]),
    ("banded.cu", BANDED_ENTRY[False][0], BANDED_ENTRY[False][1]),
    ("banded.cu", BANDED_ENTRY[True][0], BANDED_ENTRY[True][1]),
    ("ftf_bwd.cu", "lct_ftf_backward_bf16", _BWD_ARGTYPES),
    ("ftf_bwd.cu", "lct_ftf_backward_f32", _BWD_ARGTYPES),
])
def test_entry_points_take_the_widths(source, entry, argtypes):
    """Each forward and backward entry point is declared with as many
    argtypes as it has parameters (ctypes does not check them), the widths
    among them."""
    assert _c_params(source)[entry] == len(argtypes)

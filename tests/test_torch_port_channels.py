"""The port at bottleneck widths other than C = 64, on the CPU: each module
that holds a kernel and the whole enhancer against the JAX package on the
same seeded numpy inputs, at (C, num_heads, gru_groups) in CASES (heads of
32 .. 3 channels, groups of 64 .. 3 units, C = 48 and 96 among them), the
operands the CUDA wrappers hand the kernels at C = 48 and 96 (zero-padded
to 64 and 128), the width checks the card's entry points make, and the
per-kernel-width build command (tests/test_torch_port_any_width.py takes
the widths whose padded layout passes the next power of two).

Tolerances, as in test_torch_port_widths.py:
  f32 (precise): the port's plain version against the JAX package's f32
    reference, sum order only: 1e-4 (FTF block, enhancer), 1e-5
    (attention, GRU).
  bf16: the port's plain version against the JAX Pallas kernel in
    interpret mode (the FTF block): max |diff| <= 2e-2 per 8 of the
    output's largest magnitude (at least 2e-2), its mean under a tenth of
    the f32 reference's distance from the kernel, correlation > 0.99999.
    The output grows with C (sums over C channels of these weights: |out|
    up to 4.9 at C = 32, 9.2 at 96, 12.9-20.5 at 128), and a value that
    f32 sum order moves across a bf16 rounding boundary moves it by one
    bf16 ulp of its own size: found max |diff| 0.027-0.032 at C = 128 (1
    head, 2 groups), 0.018 at 96, 0.0046 at 48 (3, 3), 5e-7 at 32; the
    means 1-4% of the f32 distance, correlation > 0.9999996.
  The padded operands, run through the plain versions with the kernels'
    LayerNorm divisor and score scale: 1e-5 against the unpadded block, and
    exactly 0 on every padded output channel.
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
                                             pad_attention)
from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                    banded_mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference, fused_ftf_block,
                                       kernel_operands)
from lct_gan_tpu_torch.ops.ftf_bwd import check_backward_shapes
from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru, grouped_gru,
                                       grouped_gru_plain, gru_kernel_operands)
from lct_gan_tpu_torch.ops.library import (BACKWARD_WIDTHS, KERNEL_WIDTHS,
                                           card_takes, divisors)

from test_torch_port_widths import (ORDER, _attn_params, _ftf_params, _j,
                                    _key_bias, _t)

CASES = [(32, 4, 4), (48, 3, 3), (48, 16, 16), (96, 6, 12), (128, 1, 2)]
KINDS = ["freq", "time_key_bias", "time_lookback"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ftf_inputs(C, nh, G, kind):
    bidi = kind == "freq"
    N, L = (12, 17) if bidi else (6, 24)
    rng = np.random.default_rng(1000 * C + 10 * nh + G)
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    p = _ftf_params(rng, bidi, G, C)
    kb = _key_bias(rng, N, L) if kind == "time_key_bias" else None
    kw = dict(bidirectional=bidi, num_heads=nh,
              lookback=7 if kind == "time_lookback" else None)
    return x, p, kb, kw


@pytest.mark.parametrize("C,nh,G", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_ftf_block_matches_jax(C, nh, G, kind):
    """The FTF block at C channels: the f32 plain version against the JAX
    f32 reference, bf16 mode against the JAX Pallas kernel in interpret
    mode (which reads C, heads and groups from its shapes)."""
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
    assert np.abs(got - want).mean() < 0.1 * np.abs(want32 - want).mean()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("C,nh,G", CASES)
def test_attention_and_gru_match_jax(C, nh, G):
    """MHSA with a key-masked tail, banded MHSA (S = 50, W = 16) and LN1 +
    the grouped GRU (both directions), all f32, against the JAX package."""
    rng = np.random.default_rng(C + nh)
    x = rng.standard_normal((4, 24, C)).astype(np.float32)
    p = _attn_params(rng, C)
    kb = _key_bias(rng, 4, 24)
    jp, tp = [jnp.asarray(a) for a in p], [torch.from_numpy(a) for a in p]
    want = np.asarray(jax_mhsa_reference(jnp.asarray(x), *jp, num_heads=nh,
                                         key_bias=_j(kb)))
    got = fused_mhsa(torch.from_numpy(x), *tp, num_heads=nh,
                     key_bias=_t(kb), precise=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    xb = rng.standard_normal((2, 50, C)).astype(np.float32)
    kbb = np.zeros((2, 50), np.float32)
    kbb[0, 41:] = -1e30
    want = np.asarray(jax_banded_reference(
        jnp.asarray(xb), *jp, num_heads=nh, lookback=16, key_bias=_j(kbb)))
    got = banded_mhsa(torch.from_numpy(xb), *tp, num_heads=nh, lookback=16,
                      key_bias=_t(kbb), precise=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    xg = rng.standard_normal((3, 12, C)).astype(np.float32)
    q = _ftf_params(rng, True, G, C)
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


@pytest.mark.parametrize("enc,nh,G", [((16, 32, 48), 3, 3),
                                      ((32, 64, 128), 1, 2)])
def test_enhancer_matches_jax(enc, nh, G):
    """The whole LctEnhancer at these widths: the JAX package's initialised
    parameters carried across by jax_params_to_state_dict (strict=True),
    both run all-f32 on the same waves."""
    dec = enc[::-1]
    wave = (0.1 * np.random.default_rng(enc[-1]).standard_normal(
        (2, 6000))).astype(np.float32)
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


def _kernel_layer_norm(C):
    """The kernels' LayerNorm on padded rows: sums over every channel (the
    padded ones hold 0), divided by the true width C."""
    def ln(x, scale, bias, eps=1e-6):
        mu = x.sum(-1, keepdim=True) / C
        var = torch.clamp((x * x).sum(-1, keepdim=True) / C - mu * mu,
                          min=0.0)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return ln


def _kernel_heads(C, nh, in_w, in_b):
    """(head count the kernels run, in_w, in_b with q scaled so that the
    plain version's 1 / sqrt(padded width) is the kernels' 1 / sqrt(true
    width)), for padded in_w [CK, 3 CK]."""
    CK, hd = in_w.shape[1] // 3, C // nh
    hdp = padding.head_width(hd)       # csrc/common.cuh's head_width
    r = float(hdp / hd) ** 0.5
    in_w, in_b = in_w.clone(), in_b.clone()
    in_w[:, :CK] *= r
    in_b[:CK] *= r
    return CK // hdp, in_w, in_b


def _padded_channels(idx, CK):
    return [c for c in range(CK) if c not in set(idx.tolist())]


@pytest.mark.parametrize("C,nh,G", [c for c in CASES if c[0] in (48, 96)]
                         + [(48, 1, 16), (96, 32, 1), (48, 24, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_padded_ftf_operands_are_the_same_block(monkeypatch, C, nh, G, kind):
    """What the CUDA wrapper hands the kernels at C = 48 and 96
    (`ops/ftf.py::kernel_operands`: channels and heads zero-padded to a
    power of two, the GRU packed into slots) computes the same block: run
    through the plain version with the kernels' LayerNorm divisor and score
    scale, its C true channels equal the unpadded block and every padded
    channel is exactly 0, out and hiddens alike."""
    x, p, kb, kw = _ftf_inputs(C, nh, G, kind)
    targs = [torch.from_numpy(x)] + [torch.from_numpy(p[k]) for k in ORDER]
    want, want_hid = ftf_block_reference(*targs, key_bias=_t(kb),
                                         precise=True, return_hidden=True,
                                         **kw)
    ops, cidx = kernel_operands([*targs, _t(kb)], nh)
    CK = padding.kernel_width(C, nh, G)
    assert cidx is not None and ops[0].shape[-1] == CK
    nhk, ops[9], ops[10] = _kernel_heads(C, nh, ops[9], ops[10])
    monkeypatch.setattr(ftf_ops, "layer_norm", _kernel_layer_norm(C))
    got, hid = ftf_block_reference(*ops[:15], key_bias=ops[15], precise=True,
                                   return_hidden=True,
                                   **dict(kw, num_heads=nhk))
    torch.testing.assert_close(got[..., cidx], want, rtol=0, atol=1e-5)
    torch.testing.assert_close(hid[..., cidx], want_hid, rtol=0, atol=1e-5)
    pad = _padded_channels(cidx, CK)
    assert got[..., pad].abs().max() == 0 and hid[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,nh,G", [(48, 3, 16), (48, 16, 2), (96, 12, 3),
                                    (96, 32, 8), (96, 1, 1)])
def test_padded_attention_and_gru_operands(monkeypatch, C, nh, G):
    """The same for the MHSA and banded wrappers (`pad_attention`: x's
    channels first, each head widened) and the composed GRU's
    (`gru_kernel_operands`: each group widened, units packed into
    slots)."""
    rng = np.random.default_rng(C * nh + G)
    x = torch.from_numpy(rng.standard_normal((3, 30, C)).astype(np.float32))
    p = [torch.from_numpy(a) for a in _attn_params(rng, C)]
    kb = torch.from_numpy(_key_bias(rng, 3, 30))
    for ref, kw in ((mhsa_reference, {}),
                    (banded_mhsa_reference, {"lookback": 9})):
        want = ref(x, *p, num_heads=nh, key_bias=kb, precise=True, **kw)
        ops, padded = pad_attention([x, *p, kb], nh)
        assert padded
        nhk, ops[1], ops[2] = _kernel_heads(C, nh, ops[1], ops[2])
        got = ref(*ops[:5], num_heads=nhk, key_bias=ops[5], precise=True,
                  **kw)
        torch.testing.assert_close(got[..., :C], want, rtol=0, atol=1e-5)
        assert got[..., C:].abs().max() == 0

    q = {k: torch.from_numpy(v) for k, v in _ftf_params(rng, True, G,
                                                         C).items()}
    gru = [q[k] for k in ("ln1_scale", "ln1_bias", "w_ih", "w_hh", "b_ih",
                          "b_hh")]
    want = grouped_gru_plain(x, *gru, True)
    ops, idx = gru_kernel_operands([x, *gru])
    monkeypatch.setattr(gru_ops, "layer_norm", _kernel_layer_norm(C))
    got = gru_ops.grouped_gru_plain(*ops, True)
    torch.testing.assert_close(got[..., idx], want, rtol=0, atol=1e-5)
    pad = _padded_channels(idx, padding.kernel_width(C, groups=G))
    assert got[..., pad].abs().max() == 0


@pytest.mark.parametrize("C,G", [(48, 16), (48, 8), (48, 2), (96, 8),
                                 (96, 32), (96, 4)])
def test_zero_padded_gru_units_compute_the_same_gru(C, G):
    """Groups whose width does not divide 16 (3, 6, 24 units at C = 48; 12,
    3, 24 at 96): widened with zero units to a power of two and packed into
    the kernels' slots, they run the same GRU on the true channels, and the
    padded units stay exactly 0 (zero weights and biases: r = z = 1/2, n =
    0)."""
    rng = np.random.default_rng(C + G)
    H = C // G
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
         for s in ((2, G, H, 3 * H), (2, G, H, 3 * H), (2, G, 3 * H),
                   (2, G, 3 * H))]
    x = torch.from_numpy(rng.standard_normal((3, 7, C)).astype(np.float32))
    CK, idx = padding.kernel_width(C, groups=G), padding.channel_map(C, G)
    packed = gru_ops.pack_gru_slots(*padding.pad_gru(*w, C))
    W = packed[0].shape[2]
    assert W in (16, 64, CK) and packed[0].shape[1] == CK // W
    want = grouped_gru(x, *w, bidirectional=True)
    got = grouped_gru(padding.pad_last(x, idx, CK), *packed,
                      bidirectional=True)
    torch.testing.assert_close(got[..., idx], want, rtol=0, atol=1e-6)
    assert got[..., _padded_channels(idx, CK)].abs().max() == 0


def test_card_widths_take_the_channel_set():
    """Training and serving on the card take every C whose padded layout
    fits 512 channels, with every such divisor pair of heads and groups
    (the name is kept from when a set of six widths was taken): C = 40, 48
    and 96 among them, and (100, 5, 5), C = 144 and (200, 5, 5) (their
    layouts fit 512 channels); (400, 5, 5) (640) is refused for both,
    naming enc_channels, the flags and the channels the layout needs.
    Decided from the device argument: no card is queried."""
    def cfg(C, nh=4, G=4):
        return LCTGeneratorConfig(enc_channels=(16, 32, C),
                                  dec_channels=(C, 32, 16), num_heads=nh,
                                  gru_groups=G)

    for training in (False, True):
        for C in (8, 16, 32, 40, 48, 50, 64, 96, 128):
            for nh in divisors(C):
                for G in divisors(C):
                    if card_takes(C, nh, G):
                        check_card_widths(cfg(C, nh, G), "cuda",
                                          training=training)
        for C, nh, G, need in ((100, 5, 5, 160), (144, 4, 4, 256),
                               (200, 5, 5, 320), (400, 5, 5, 640)):
            top = 512
            if need <= top:
                check_card_widths(cfg(C, nh, G), "cuda:0", training=training)
                continue
            with pytest.raises(ValueError, match=(
                    rf"padded layout fits {top} channels, got "
                    rf"enc_channels\[-1\]={C}, --num_heads {nh}, "
                    rf"--gru_groups {G}: the padded layout needs {need} "
                    rf"channels \(> {top}\)")):
                check_card_widths(cfg(C, nh, G), "cuda:0", training=training)
            check_card_widths(cfg(C, nh, G), "cpu", training=training)
    check_card_widths(cfg(48, 3, 3), torch.device("cuda", 0), training=True)
    check_card_widths(cfg(40), torch.device("cuda", 0), training=True)


def test_grad_on_the_card_is_refused_before_any_launch():
    """fused_ftf_block under grad on a CUDA tensor at widths whose padded
    layout passes 512 channels ((400, 5, 5): 640) raises in the backward
    kernel's check (naming enc_channels) before the forward launches; on
    shapes alone (fake CUDA tensors). The same check takes C = 48 at 3
    heads and 3 groups, 40 at 4 and 4, 50 at 5 and 5, (100, 5, 5), whose
    layout of 160 channels runs at kernel width 256, and (200, 5, 5),
    whose layout of 320 runs at 512."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kw = dict(bidirectional=True, lookback=None)
    shapes = {C: [_ftf_params(np.random.default_rng(0), True, G, C)[k].shape
                  for k in ORDER] for C, G in ((400, 5), (48, 3), (40, 4),
                                               (50, 5), (100, 5), (200, 5))}
    with FakeTensorMode():
        xs = torch.empty((12, 17, 400), device="cuda")
        ps = [torch.empty(s, device="cuda").requires_grad_()
              for s in shapes[400]]
        with pytest.raises(ValueError,
                           match=r"C=400.*640 channels.*enc_channels"):
            fused_ftf_block(xs, *ps, precise=False, num_heads=5, **kw)
    for C, nh in ((48, 3), (40, 4), (50, 5), (100, 5), (200, 5)):
        check_backward_shapes(
            "fused_ftf_block under grad",
            torch.zeros((12, 17, C), device="meta"),
            torch.zeros(shapes[C][2], device="meta"),
            torch.zeros(shapes[C][12], device="meta"), nh, True)


def test_per_width_build_command():
    """Kernel width 64 builds every source with the command, flags and
    library path it always had; any other kernel width builds the forward
    sources with -DLCT_C=<width> into a library of its own, and the FTF
    backward's at every one of them, 512 included (BACKWARD_WIDTHS); no
    other width has libraries (48 runs at 64, 1024 is refused by name). No
    nvcc is needed to say so."""
    tag = "0123456789abcdef"
    cmd64 = _build.build_command("ftf", 64, "out.so", "nvcc")
    assert cmd64 == ["nvcc", *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                     "-o", "out.so", f"{_build.CSRC_DIR}/ftf.cu"]
    assert _build.library_path("ftf", 64, tag).endswith(f"/libftf-{tag}.so")
    assert _build.library_sources(64) == sorted(
        ("banded", "ftf", "ftf_bwd", "mhsa", "probe"))
    paths = {_build.library_path("ftf", 64, tag)}
    for C in KERNEL_WIDTHS:
        if C == 64:
            continue
        cmd = _build.build_command("mhsa", C, "o.so", "nvcc", verbose=True)
        assert f"-DLCT_C={C}" in cmd and cmd[-1].endswith("/mhsa.cu")
        assert cmd[:len(_build.NVCC_FLAGS) + 1] == ["nvcc",
                                                    *_build.NVCC_FLAGS]
        assert _build.library_sources(C) == ["banded", "ftf", "mhsa"]
        assert C in BACKWARD_WIDTHS
        assert _build.library_sources(C, backward=True) == [
            "banded", "ftf", "ftf_bwd", "mhsa"]
        path = _build.library_path("ftf", C, tag)
        assert path.endswith(f"/libftf-c{C}-{tag}.so")
        paths.add(path)
    assert len(paths) == len(KERNEL_WIDTHS)
    assert BACKWARD_WIDTHS == KERNEL_WIDTHS
    with pytest.raises(ValueError, match="ftf_bwd.*C=1024|C=1024"):
        _build.library_sources(1024, backward=True)
    for C in (40, 48, 1024):
        with pytest.raises(ValueError, match=f"C={C}"):
            _build.library_sources(C)
        with pytest.raises(ValueError, match=f"C={C}"):
            _build.library_sources(C, backward=True)

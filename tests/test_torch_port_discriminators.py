"""The port's discriminators (lct_gan_tpu_torch/models/discriminators.py,
norm.py) and their weight bridge against the JAX package's, on the CPU: JAX
params converted by `jax_disc_params_to_state_dict`, the same seeded wave.

The port runs NCHW / NCT, the JAX package channels-last: feature maps are
compared after a transpose. f32 products over up to 5,120 terms in another
order: 2e-5 of each tensor's largest magnitude.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.convert.torch_export import (export_mpd_state_dict,
                                              export_msd_state_dict)
from lct_gan_tpu.models import discriminators as jd
from lct_gan_tpu_torch.convert import jax_disc_params_to_state_dict
from lct_gan_tpu_torch.models.discriminators import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator,
    avg_pool1d_no_pad_count)
from lct_gan_tpu_torch.models.generator import LctEnhancer

T = 1201   # not a multiple of any period: every PeriodDiscriminator pads


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    return (0.1 * rng.standard_normal((2, T))).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _make_pair(sn):
    """(sn, JAX models, JAX variables, port models) with the same weights."""
    mpd = jd.MultiPeriodDiscriminator(use_spectral_norm=sn)
    msd = jd.MultiScaleDiscriminator(use_spectral_norm=sn)
    w = jnp.zeros((2, T), jnp.float32)
    mv = jax.jit(mpd.init)(jax.random.PRNGKey(1), w)
    sv = jax.jit(msd.init)(jax.random.PRNGKey(2), w)
    spectral = ({"mpd": _np_tree(mv["spectral"]),
                 "msd": _np_tree(sv["spectral"])} if sn else None)
    mpd_sd, msd_sd = jax_disc_params_to_state_dict(
        _np_tree(mv["params"]), _np_tree(sv["params"]), spectral)
    tm = MultiPeriodDiscriminator(use_spectral_norm=sn)
    ts = MultiScaleDiscriminator(use_spectral_norm=sn)
    tm.load_state_dict(mpd_sd, strict=True)
    ts.load_state_dict(msd_sd, strict=True)
    return sn, (mpd, msd), (mv, sv), (tm, ts)


@pytest.fixture(scope="module", params=[False, True], ids=["wn", "sn"])
def pair(request):
    return _make_pair(request.param)


def _channels_last(t):
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t.permute(0, 2, 1)


def _assert_maps_close(got, want, rel=2e-5):
    got = _channels_last(got.float()).detach().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_logits_and_fmaps_match_jax(pair, wave):
    """Eval forwards (spectral norm with the stored u/v, no update)."""
    sn, jmods, jvars, tmods = pair
    for jm, jv, tm in zip(jmods, jvars, tmods):
        j_logits, j_fmaps = jax.jit(jm.apply)(jv, jnp.asarray(wave))
        with torch.no_grad():
            t_logits, t_fmaps = tm(torch.from_numpy(wave))
        assert len(t_logits) == len(j_logits)
        for a, b in zip(t_logits, j_logits):
            assert a.dtype == torch.float32
            _assert_maps_close(a, b)
        for fa, fb in zip(t_fmaps, j_fmaps):
            assert len(fa) == len(fb)
            for a, b in zip(fa, fb):
                _assert_maps_close(a, b)


def test_spectral_norm_update_matches_jax(wave):
    """One training forward: a power iteration on the [out, -1]
    matricisation (torch column order in the port, the JAX package's
    (k..., in) order there), sigma from the updated u and v."""
    _, jmods, jvars, tmods = _make_pair(True)
    jm, jv, tm = jmods[0], jvars[0], tmods[0]
    (j_logits, _), upd = jax.jit(functools.partial(
        jm.apply, mutable=["spectral"]))(jv, jnp.asarray(wave))
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        with torch.no_grad():
            t_logits, _ = tm(torch.from_numpy(wave), update_sn=True)
        for a, b in zip(t_logits, j_logits):
            _assert_maps_close(a, b)
        want_sd, _ = jax_disc_params_to_state_dict(
            _np_tree(jv["params"]), _np_tree(jvars[1]["params"]),
            {"mpd": _np_tree(upd["spectral"]),
             "msd": _np_tree(jvars[1]["spectral"])})
        got_sd = tm.state_dict()
        keys = [k for k in want_sd if k.endswith(("weight_u", "weight_v"))]
        assert len(keys) == 2 * 6 * 5
        moved = 0.0
        for k in keys:
            torch.testing.assert_close(got_sd[k], want_sd[k], rtol=1e-5,
                                       atol=1e-6)
            moved = max(moved, (got_sd[k] - state[k]).abs().max().item())
        assert moved > 1e-3
    finally:
        tm.load_state_dict(state)


def test_bridge_matches_jax_package_exporter(pair):
    sn, _, (mv, sv), _ = pair
    mpd_sd, msd_sd = jax_disc_params_to_state_dict(
        _np_tree(mv["params"]), _np_tree(sv["params"]),
        {"mpd": _np_tree(mv["spectral"]), "msd": _np_tree(sv["spectral"])}
        if sn else None)
    for ours, theirs in (
            (mpd_sd, export_mpd_state_dict(
                mv["params"], mv.get("spectral") if sn else None)),
            (msd_sd, export_msd_state_dict(
                sv["params"], sv.get("spectral") if sn else None))):
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))


def test_pinned_parameter_counts():
    g = torch.Generator().manual_seed(0)
    counts = (
        sum(p.numel() for p in LctEnhancer().parameters()),
        sum(p.numel() for p in MultiPeriodDiscriminator(
            generator=g).parameters()),
        sum(p.numel() for p in MultiScaleDiscriminator(
            generator=g).parameters()))
    assert counts == (135425, 785770, 16924086)


@pytest.mark.parametrize("length", [1, 2, 7, 100, 3001])
def test_avg_pool_is_jax_no_pad_count_pool(length):
    """F.avg_pool1d(4, 2, 2, count_include_pad=False) on [B, C, T] equals the
    JAX package's `_avg_pool1d_no_pad_count` on [B, T, C]."""
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    want = np.asarray(jd._avg_pool1d_no_pad_count(jnp.asarray(x)))
    got = avg_pool1d_no_pad_count(torch.from_numpy(x).permute(0, 2, 1))
    np.testing.assert_allclose(got.permute(0, 2, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_init_is_fan_in_uniform_with_g_the_norm():
    m = MultiScaleDiscriminator(generator=torch.Generator().manual_seed(3))
    conv = m.discriminators[0].convs[3]          # 1024 out, 4 in/group, k 41
    bound = (1.0 / (4 * 41)) ** 0.5
    v = conv.weight_v.detach()
    assert v.abs().max() <= bound and v.abs().max() > 0.99 * bound
    assert torch.equal(conv.bias, torch.zeros(1024))
    torch.testing.assert_close(conv.weight(), v, rtol=1e-6, atol=1e-7)


def test_bf16_compute_keeps_fmaps_bf16_and_logits_f32(wave):
    """bf16 casts the input and the normalised weight; parameters stay f32.
    Against the JAX bf16 forward on the same weights: a bf16 noise band."""
    mpd = jd.MultiPeriodDiscriminator(periods=(2, 3), dtype=jnp.bfloat16)
    w = jnp.asarray(wave)
    jv = jax.jit(mpd.init)(jax.random.PRNGKey(4), w)
    tm = MultiPeriodDiscriminator(periods=(2, 3), dtype=torch.bfloat16)
    mpd_sd, _ = jax_disc_params_to_state_dict(
        _np_tree(jv["params"]), {}, periods=(2, 3), num_scales=0)
    tm.load_state_dict(mpd_sd, strict=True)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    j_logits, j_fmaps = jax.jit(mpd.apply)(jv, w)
    with torch.no_grad():
        t_logits, t_fmaps = tm(torch.from_numpy(wave))
    for a, b in zip(t_logits, j_logits):
        assert a.dtype == torch.float32
        _assert_maps_close(a, b, rel=5e-2)
    for fa in t_fmaps:
        assert all(f.dtype == torch.bfloat16 for f in fa[:-1])
        assert fa[-1].dtype == torch.float32

"""The port's GAN train step (lct_gan_tpu_torch/train) against the JAX
package's, on the CPU: one JAX `create_state` (TrainConfig(segment_seconds=
0.25, batch_size=2), as tests/test_train_step.py uses) converted through the
weight bridge, the same seeded batch, the port in precise (all-f32) mode.

  * D and G gradients of step 1 against jax.grad of the same losses, built
    here from the JAX package's public functions (1e-3 of each leaf's
    largest magnitude);
  * d_loss, g_loss and the aux metrics of steps 1-3 (1e-4 relative);
  * the port's AdamW and clip against optax on identical gradients (1e-6);
  * determinism, both spectral-norm modes, the eval step with lengths.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lct_gan_tpu.losses import (discriminator_loss, feature_matching_loss,
                                flatten_logits_lists, generator_adv_loss,
                                mask_mse_loss, mr_stft_loss)
from lct_gan_tpu.sigproc import TFFeaturesConfig, compute_tf_features
from lct_gan_tpu.train.state import TrainConfig as JaxTrainConfig
from lct_gan_tpu.train.state import build_models as jax_build_models
from lct_gan_tpu.train.state import create_state as jax_create_state
from lct_gan_tpu.train.step import _masked_si_sdr
from lct_gan_tpu.train.step import align_tf_targets as jax_align
from lct_gan_tpu.train.step import make_eval_step as jax_make_eval_step
from lct_gan_tpu.train.step import make_train_step as jax_make_train_step
from lct_gan_tpu_torch.convert import (jax_disc_params_to_state_dict,
                                       jax_params_to_state_dict)
from lct_gan_tpu_torch.train import (TrainConfig, align_tf_targets,
                                     clip_by_global_norm, create_state,
                                     discriminator_step_loss,
                                     generator_step_loss, make_eval_step,
                                     make_optimizers, make_train_step,
                                     masked_si_sdr, state_from_jax_params)
from lct_gan_tpu_torch.sigproc.features import (
    TFFeaturesConfig as PortTFFeaturesConfig)
from lct_gan_tpu_torch.sigproc.features import (
    compute_tf_features as port_tf_features)

KW = dict(segment_seconds=0.25, batch_size=2)
JCFG, CFG = JaxTrainConfig(**KW), TrainConfig(**KW)
METRICS = ("d_loss", "g_loss", "mr_loss", "mask_loss", "adv_loss", "fm_loss")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_state():
    return jax_create_state(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    seg = CFG.segment_length
    clean = (rng.standard_normal((2, seg)) * 0.1).astype(np.float32)
    noise = (rng.standard_normal((2, seg)) * 0.05).astype(np.float32)
    return clean + noise, clean


def _port_state(jax_state, cfg=CFG):
    return state_from_jax_params(
        cfg, _np(jax_state.g_params), _np(jax_state.mpd_params),
        _np(jax_state.msd_params), device="cpu", precise=True)


@pytest.fixture(scope="module")
def jax_metrics(jax_state, batch):
    """The JAX package's metrics of steps 1-3 on one batch."""
    step = jax.jit(jax_make_train_step(JCFG))
    s, out = jax_state, []
    for _ in range(3):
        s, m = step(s, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_metrics_of_steps_1_to_3_match_jax(jax_state, batch, jax_metrics):
    state = _port_state(jax_state)
    step = make_train_step(CFG)
    for want in jax_metrics:
        got = {k: float(v) for k, v in step(state, *batch).items()}
        assert set(got) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert state.step == 3


def _jax_grads(jax_state, noisy, clean):
    """jax.grad of step 1's D loss and of its G loss (against the same, not
    yet updated, discriminators), from the JAX package's public functions."""
    enhancer, mpd, msd = jax_build_models(JCFG)
    irm_c = compute_tf_features(noisy, clean, TFFeaturesConfig(
        c=JCFG.compress_c, return_stfts=False))["irm_c"]
    b = clean.shape[0]

    def disc(d_params, x):
        (ml, mf) = mpd.apply({"params": d_params["mpd"]}, x)
        (sl, sf) = msd.apply({"params": d_params["msd"]}, x)
        return ml, mf, sl, sf

    def d_loss(d_params):
        fake = jax.lax.stop_gradient(
            enhancer.apply({"params": jax_state.g_params}, noisy)[0])
        ml, _, sl, _ = disc(d_params, jnp.concatenate([clean, fake]))
        return discriminator_loss(
            flatten_logits_lists([l[:b] for l in ml], [l[:b] for l in sl]),
            flatten_logits_lists([l[b:] for l in ml], [l[b:] for l in sl]))

    def g_loss(g_params, d_params):
        enhanced, mask_c = enhancer.apply({"params": g_params}, noisy)
        irm_a, pred_a = jax_align(irm_c, mask_c[:, 0])
        ml, mf, sl, sf = disc(d_params, jnp.concatenate([enhanced, clean]))
        fake_fm = [[f[:b] for f in fs] for fs in mf + sf]
        real_fm = jax.lax.stop_gradient(
            [[f[b:] for f in fs] for fs in mf + sf])
        adv = generator_adv_loss(
            flatten_logits_lists([l[:b] for l in ml], [l[:b] for l in sl]))
        return (mr_stft_loss(enhanced, clean)[0]
                + JCFG.lambda_mask * mask_mse_loss(pred_a, irm_a)
                + JCFG.lambda_adv * (adv + JCFG.lambda_fm *
                                     feature_matching_loss(real_fm, fake_fm)))

    d_params = {"mpd": jax_state.mpd_params, "msd": jax_state.msd_params}
    return jax.jit(lambda g, d: (jax.grad(d_loss)(d), jax.grad(g_loss)(g, d)))(
        jax_state.g_params, d_params)


def test_step_1_gradients_match_jax(jax_state, batch):
    noisy, clean = (jnp.asarray(a) for a in batch)
    jd, jg = _jax_grads(jax_state, noisy, clean)
    want_g = jax_params_to_state_dict(_np(jg))
    want_d = jax_disc_params_to_state_dict(_np(jd["mpd"]), _np(jd["msd"]))

    state = _port_state(jax_state)
    n, c = (torch.from_numpy(a) for a in batch)
    irm_c = port_tf_features(n, c, PortTFFeaturesConfig(
        c=CFG.compress_c, return_stfts=False))["irm_c"]
    enhanced, mask_c = state.enhancer(n)
    d_loss = discriminator_step_loss(CFG, state.mpd, state.msd, c,
                                     enhanced.detach())
    g_loss, _ = generator_step_loss(CFG, state.mpd, state.msd, enhanced,
                                    mask_c, irm_c, c)
    for module, loss, want in ((state.mpd, d_loss, want_d[0]),
                               (state.msd, d_loss, want_d[1]),
                               (state.enhancer, g_loss, want_g)):
        names, params = zip(*module.named_parameters())
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        assert set(names) <= set(want)
        for name, got in zip(names, grads):
            ref = want[name].numpy()
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-3 * scale + 1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("clip", [5.0, 1e-3])
def test_adamw_and_clip_match_optax(clip):
    """Three updates from identical gradients; clip 1e-3 always triggers,
    5.0 never does."""
    rng = np.random.default_rng(1)
    shapes = [(7, 3), (5,), (2, 3, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
             for _ in range(3)]
    cfg = TrainConfig(grad_clip=clip)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(cfg.lr_g, b1=cfg.betas_g[0],
                                 b2=cfg.betas_g[1], eps=1e-8,
                                 weight_decay=0.01))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    g_opt, _ = make_optimizers(cfg, tp, [torch.nn.Parameter(torch.zeros(1))])
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(a) for a in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        clipped = clip_by_global_norm([torch.from_numpy(a) for a in g], clip)
        for p, a in zip(tp, clipped):
            p.grad = a
        g_opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


def test_two_runs_from_one_state_are_bit_equal(jax_state, batch):
    state = _port_state(jax_state)
    step = make_train_step(CFG)
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    ma, mb = step(a, *batch), step(b, *batch)
    assert all(torch.equal(ma[k], mb[k]) for k in METRICS)
    for p, q in zip([*a.g_params(), *a.d_params()],
                    [*b.g_params(), *b.d_params()]):
        assert torch.equal(p, q)
        assert p.grad is None     # the G step leaves no gradient behind


@pytest.mark.parametrize("fast", [False, True], ids=["parity", "fast"])
def test_spectral_norm_steps(batch, fast):
    """Both spectral-norm modes train: finite metrics, every u/v buffer
    power-iterated, parameters moved. Parity runs each stack clean, then
    fake (D step) and fake, then clean (G step): 4 iterations per SN conv;
    fast: 2."""
    cfg = TrainConfig(use_spectral_norm=True, fast_spectral_norm=fast, **KW)
    state = create_state(cfg, torch.Generator().manual_seed(0),
                         device="cpu", precise=True)
    before = {k: v.clone() for k, v in state.mpd.state_dict().items()
              if k.endswith("weight_v") and "orig" not in k}
    counted = []
    conv = state.mpd.discriminators[0].convs[0]
    orig = conv.weight

    def counting(update=False):
        counted.append(update)
        return orig(update)

    conv.weight = counting
    m = make_train_step(cfg)(state, *batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert counted.count(True) == (2 if fast else 4)
    after = state.mpd.state_dict()
    assert all((after[k] - v).abs().max() > 0 for k, v in before.items())


def test_eval_step_matches_jax(jax_state, batch):
    noisy, clean = batch
    lengths = np.asarray([CFG.segment_length, CFG.segment_length - 1234])
    want_enh, want = jax.jit(jax_make_eval_step(JCFG))(
        jax_state.g_params, noisy, clean, lengths)
    state = _port_state(jax_state)
    enh, got = make_eval_step(CFG)(state.enhancer, noisy, clean, lengths)
    np.testing.assert_allclose(enh.numpy(), np.asarray(want_enh), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["mrstft"].numpy(), np.asarray(
        want["mrstft"]), rtol=1e-4)
    np.testing.assert_allclose(got["si_sdr"].numpy(), np.asarray(
        want["si_sdr"]), rtol=0, atol=1e-3)


def test_masked_si_sdr_and_alignment_match_jax():
    rng = np.random.default_rng(2)
    ref = (0.2 * rng.standard_normal((3, 900))).astype(np.float32)
    est = ref + (0.05 * rng.standard_normal((3, 900))).astype(np.float32)
    lengths = np.asarray([900, 500, 1])
    want = _masked_si_sdr(jnp.asarray(ref), jnp.asarray(est),
                          jnp.asarray(lengths))
    got = masked_si_sdr(torch.from_numpy(ref), torch.from_numpy(est),
                        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    a, b = np.zeros((2, 5, 9), np.float32), np.zeros((2, 5, 7), np.float32)
    for got_pair, want_pair in zip(
            align_tf_targets(torch.from_numpy(a), torch.from_numpy(b)),
            jax_align(jnp.asarray(a), jnp.asarray(b))):
        assert tuple(got_pair.shape) == want_pair.shape == (2, 5, 7)


def test_create_state_is_seeded_and_loads_generator_weights(jax_state):
    a = create_state(CFG, torch.Generator().manual_seed(3), device="cpu")
    b = create_state(CFG, torch.Generator().manual_seed(3), device="cpu",
                     g_params=_np(jax_state.g_params))
    for p, q in zip(a.d_params(), b.d_params()):
        assert torch.equal(p, q)
    want = jax_params_to_state_dict(_np(jax_state.g_params))
    for k, v in b.enhancer.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert isinstance(a.g_opt, torch.optim.AdamW) and a.step == 0

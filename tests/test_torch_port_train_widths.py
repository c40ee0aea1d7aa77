"""Training at widths other than 4 heads and 4 GRU groups, on the CPU: the
FTF backward and the GAN train step of the port against the JAX package's
at (num_heads, gru_groups) in {(8, 8), (2, 2), (1, 1), (16, 4)} (C = 64),
and the packing of GRU gradients into the CUDA kernels' slots and back.

  * `ftf_bwd_reference` against the JAX package's backward kernel
    `fused_ftf_bwd` in interpret mode, on the same seeded inputs and
    hiddens, as tests/test_torch_port_ftf_bwd.py compares them at 4 and 4:
    precise against precise at the JAX package's 2e-5 band; bf16 against
    the kernel in bf16, with the cotangent zeroed within 5e-2 of the
    LeakyReLU's kink as chip_smoke.py does (two sum orders can put a
    pre-activation on different sides of 0, a 0.8 * dout jump in that
    row's gradient: 8.3e-2 of dlin_w's largest magnitude at 4 and 4 on one
    seed without the mask), then 1e-2 of each gradient's largest magnitude
    (found <= 3.1e-3 over seeds 5-7 at these widths and at 4 and 4: f32
    sum order moving a value across a bf16 rounding boundary, which the
    recurrence carries on) and correlation > 0.9999;
  * `unpack_gru_slot_grads` undoes `pack_gru_slots` exactly, and the plain
    backward on packed weights, unpacked, is the grouped one to f32 sum
    order (1e-6 of each gradient's largest magnitude): the CUDA wrapper's
    route;
  * one GAN train step of the port (all f32) against the JAX package's at
    (8, 8), from one JAX `create_state` through the weight bridge, at
    tests/test_torch_port_train_step.py's size and band: TrainConfig(
    segment_seconds=0.25, batch_size=2), the six metrics of steps 1 and 2
    within 1e-4 relative (step 2's losses see step 1's update).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lct_gan_tpu.ops.ftf_bwd import fused_ftf_bwd as jax_fused_ftf_bwd
from lct_gan_tpu.train.state import TrainConfig as JaxTrainConfig
from lct_gan_tpu.train.state import create_state as jax_create_state
from lct_gan_tpu.train.step import make_train_step as jax_make_train_step
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference
from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_reference
from lct_gan_tpu_torch.ops.gru import pack_gru_slots, unpack_gru_slot_grads
from lct_gan_tpu_torch.ops.library import divisors
from lct_gan_tpu_torch.train import (TrainConfig, make_train_step,
                                     state_from_jax_params)

from test_torch_port_ftf import ORDER, make_params

WIDTHS = [(8, 8), (2, 2), (1, 1), (16, 4)]
KERNEL_WIDTHS = divisors(64)   # the head and group counts at C = 64
BWD_CASES = [(True, None), (False, 5)]   # frequency block; time, band 5
METRICS = ("d_loss", "g_loss", "mr_loss", "mask_loss", "adv_loss", "fm_loss")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(N, L, bidi, G, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, 64)).astype(np.float32)
    w = rng.standard_normal((N, L, 64)).astype(np.float32)
    p = make_params(seed, bidi, G=G)
    return x, w, [p[k] for k in ORDER]


def _jax_hid(hid, N, L):
    """The port's hid [D, N*L, C] -> the JAX kernel's [N, L, D*C]."""
    D = hid.shape[0]
    return hid.reshape(D, N, L, 64).permute(1, 2, 0, 3).reshape(N, L, D * 64)


def _backward_pair(nh, G, bidi, lookback, precise, seed):
    """(port, JAX) backward on the same inputs and the port's hiddens; in
    bf16 mode the cotangent is zeroed near the LeakyReLU's kink."""
    N, L = 6, 9
    x, w, p = _inputs(N, L, bidi, G, seed)
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, num_heads=nh, lookback=lookback)
    out, hid = ftf_block_reference(torch.from_numpy(x), *tp,
                                   precise=precise, return_hidden=True, **kw)
    if not precise:
        act = out - torch.from_numpy(x) - hid.sum(dim=0).reshape(N, L, 64)
        comb = torch.where(act >= 0, act, act / 0.2)
        w = np.where(comb.abs().numpy() < 5e-2, 0.0, w).astype(np.float32)
    got = ftf_bwd_reference(torch.from_numpy(x), *tp, hid,
                            torch.from_numpy(w), precise=precise, **kw)
    want = jax_fused_ftf_bwd(
        jnp.asarray(x), *map(jnp.asarray, p),
        jnp.asarray(_jax_hid(hid, N, L).numpy()), jnp.asarray(w),
        block_seqs=4, sub=2, interpret=True, precise=precise, **kw)
    assert len(got) == len(want) == 15
    return got, [np.asarray(b) for b in want]


@pytest.mark.parametrize("bidi,lookback", BWD_CASES)
@pytest.mark.parametrize("nh,G", WIDTHS)
def test_precise_plain_backward_matches_jax_kernel(nh, G, bidi, lookback):
    got, want = _backward_pair(nh, G, bidi, lookback, True, seed=4)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bidi,lookback", BWD_CASES)
@pytest.mark.parametrize("nh,G", WIDTHS)
def test_bf16_plain_backward_matches_jax_kernel(nh, G, bidi, lookback):
    got, want = _backward_pair(nh, G, bidi, lookback, False, seed=5)
    for a, b in zip(got, want):
        scale = np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-2 * scale
        assert np.corrcoef(a.numpy().ravel(), b.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("G", KERNEL_WIDTHS)
def test_unpack_inverts_pack_for_every_group_count(G):
    rng = np.random.default_rng(G)
    H = 64 // G
    for D in (1, 2):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((D, G, H, 3 * H), (D, G, H, 3 * H),
                           (D, G, 3 * H), (D, G, 3 * H))]
        packed = pack_gru_slots(*grads)
        W = packed[0].shape[2]
        assert tuple(packed[0].shape) == (D, 64 // W, W, 3 * W)
        back = unpack_gru_slot_grads(*packed, G)
        for a, b in zip(back, grads):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("G", [2, 8, 16, 32, 64])
@pytest.mark.parametrize("bidi,lookback", BWD_CASES)
def test_plain_backward_on_packed_weights_is_the_grouped_one(G, bidi,
                                                            lookback):
    """The CUDA wrapper's route on the plain version: weights packed into
    slots, the backward taken in slots, the gradients unpacked."""
    N, L, nh = 3, 7, 4
    x, w, p = _inputs(N, L, bidi, G, seed=G)
    tp = [torch.from_numpy(a) for a in p]
    kw = dict(bidirectional=bidi, num_heads=nh, lookback=lookback,
              precise=True)
    _, hid = ftf_block_reference(torch.from_numpy(x), *tp,
                                 return_hidden=True, **kw)
    want = ftf_bwd_reference(torch.from_numpy(x), *tp, hid,
                             torch.from_numpy(w), **kw)
    packed = list(tp)
    packed[2:6] = pack_gru_slots(*tp[2:6])
    got = list(ftf_bwd_reference(torch.from_numpy(x), *packed, hid,
                                 torch.from_numpy(w), **kw))
    got[3:7] = unpack_gru_slot_grads(*got[3:7], G)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-6 * scale


def test_train_step_at_8_heads_8_groups_matches_jax():
    kw = dict(segment_seconds=0.25, batch_size=2, num_heads=8, gru_groups=8)
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    seg = cfg.segment_length
    clean = (rng.standard_normal((2, seg)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((2, seg)) * 0.05).astype(np.float32)

    state = state_from_jax_params(
        cfg, *(jax.tree.map(np.asarray, t) for t in (
            jstate.g_params, jstate.mpd_params, jstate.msd_params)),
        device="cpu", precise=True)
    gen = state.enhancer.gen
    assert (gen.cfg.num_heads, gen.cfg.gru_groups) == (8, 8)
    assert tuple(gen.GRUf1.kernel_params()[2].shape) == (2, 8, 8, 24)

    jstep = jax.jit(jax_make_train_step(jcfg))
    step = make_train_step(cfg)
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(noisy), jnp.asarray(clean))
        got = {k: float(v) for k, v in step(state, noisy, clean).items()}
        assert set(got) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    assert state.step == 2

"""The composed time block's LN1 + grouped GRU operator
(`torch.ops.lct_gan_tpu_torch.fused_grouped_gru`, ops/gru.py) on the CPU:

  * its CPU kernel is exactly the composed path's former arithmetic,
    `grouped_gru(layer_norm(x))`, at L = 1 and L > 512, one and two
    directions; no launch is counted;
  * `torch.library.opcheck` passes; its gradients are exactly the plain
    version's (the backward recomputes it under autograd);
  * its fake implementation gives [N, L, 64] f32, and holds a fake CUDA
    tensor to the kernel's width;
  * export: a composed block's program holds the op as one node, none
    after the portable decomposition, and both equal the eager block;
  * the port's composed time block (L = 516) goes through the operator and
    matches the JAX package's composed TimeGRUBlock on the demo weights.

The kernel on the card: tests/test_torch_cuda_gru.py.
"""

import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import lct_gan_tpu_torch  # noqa: F401  (registers the ops)
from lct_gan_tpu.models.generator import TimeGRUBlock as JaxTimeBlock
from lct_gan_tpu.ops.dispatch import pallas_override
from lct_gan_tpu_torch.convert import load_enhancer, read_npz_params
from lct_gan_tpu_torch.export_model import (_plain_decompositions,
                                            kernel_op_counts)
from lct_gan_tpu_torch.models import generator
from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru, grouped_gru,
                                       grouped_gru_plain, layer_norm)

OPS = torch.ops.lct_gan_tpu_torch
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "train_demo", "g_params_best.npz")
CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, N, L, D, C=64):
    """x [N, L, C] and (ln_scale, ln_bias, w_ih, w_hh, b_ih, b_hh), seeded
    with numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.25):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32))

    G = C // 16
    return t(N, L, C, scale=1.0), [1 + t(C), t(C), t(D, G, 16, 48),
                                   t(D, G, 16, 48), t(D, G, 48), t(D, G, 48)]


@pytest.mark.parametrize("L", [1, 513])
@pytest.mark.parametrize("D", [1, 2])
def test_cpu_kernel_is_the_composed_paths_arithmetic(L, D):
    x, p = _inputs(10 * L + D, 2, L, D)
    before = fused_grouped_gru.launches
    got = fused_grouped_gru(x, *p, bidirectional=D == 2)
    want = grouped_gru(layer_norm(x, p[0], p[1]), *p[2:],
                       bidirectional=D == 2)
    assert got.shape == (2, L, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_grouped_gru.launches == before


@pytest.mark.parametrize("D", [1, 2])
def test_opcheck(D):
    x, p = _inputs(20 + D, 3, 5, D)
    torch.library.opcheck(OPS.fused_grouped_gru.default,
                          (x.requires_grad_(), *p, D == 2), test_utils=CHECKS)


@pytest.mark.parametrize("D", [1, 2])
def test_gradients_equal_the_plain_versions(D):
    x, p = _inputs(30 + D, 3, 7, D)
    dout = _inputs(40 + D, 3, 7, 1)[0]
    leaves = [t.clone().requires_grad_() for t in (x, *p)]
    got = torch.autograd.grad(
        fused_grouped_gru(*leaves, bidirectional=D == 2), leaves, dout)
    plain = [t.clone().requires_grad_() for t in (x, *p)]
    want = torch.autograd.grad(grouped_gru_plain(*plain, D == 2), plain, dout)
    assert len(got) == 7
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fake_gives_the_output_shape_and_holds_cuda_to_the_width():
    with FakeTensorMode():
        for dev in ("cpu", "cuda"):
            x, p = _inputs(50, 4, 600, 1)
            x = torch.empty(x.shape, device=dev)
            p = [torch.empty(t.shape, device=dev) for t in p]
            out = OPS.fused_grouped_gru(x, *p, False)
            assert out.shape == (4, 600, 64) and out.dtype == torch.float32
            assert out.device.type == dev
        # 544 channels in 34 groups of 16: the plain version takes it, the
        # kernel does not (544 channels run at 1024, past the widest, 512).
        x, p = _inputs(51, 4, 600, 1, C=544)
        assert OPS.fused_grouped_gru(torch.empty(x.shape), *(
            torch.empty(t.shape) for t in p), False).shape == (4, 600, 544)
        with pytest.raises(ValueError,
                           match="fits 512 channels, got C=544.*needs 1024"):
            OPS.fused_grouped_gru(
                torch.empty(x.shape, device="cuda"),
                *(torch.empty(t.shape, device="cuda") for t in p), False)


@pytest.mark.parametrize("name,shape", [("GRUf1", (2, 3, 33, 64)),
                                        ("GRUt1", (1, 12, 2, 64))])
def test_exported_composed_block(monkeypatch, name, shape):
    """A composed block of the demo weights through torch.export: one op
    node kept, none after the portable decomposition (export_model's), and
    both programs equal the eager block. The fused block's limit is lowered
    to 8 so that short blocks compose (freq F = 33: two directions; time
    L = 12): the decomposition unrolls the recurrence, which at L = 516
    takes minutes to trace."""
    monkeypatch.setattr(generator, "MAX_FTF_SEQ", 8)
    block = getattr(load_enhancer(NPZ, device="cpu", precise=True).gen,
                    name).eval()
    x = torch.from_numpy(np.random.default_rng(60).standard_normal(
        shape).astype(np.float32))
    with torch.inference_mode():
        want = block(x)
    kept = torch.export.export(block, (x,), strict=False)
    assert kernel_op_counts(kept) == {"fused_grouped_gru": 1,
                                      "fused_mhsa": 1}
    portable = kept.run_decompositions(_plain_decompositions())
    assert kernel_op_counts(portable) == {}
    for program in (kept, portable):
        with torch.inference_mode():
            got = program.module()(x)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_composed_time_block_matches_jax_through_the_op(monkeypatch):
    """The demo weights' GRUt1 at L = 516 with a key mask (B = 1, F = 2):
    the JAX package's composed block (lax.scan GRU, jnp attention) against
    the port's, which calls the operator once."""
    params, _ = read_npz_params(NPZ)
    block_params = jax.tree.map(jnp.asarray, params["gen"]["GRUt1"])
    rng = np.random.default_rng(70)
    x = rng.standard_normal((1, 516, 2, 64)).astype(np.float32)
    valid = np.array([500], np.int32)
    with pallas_override(None):
        want = jax.jit(lambda p, a, v: JaxTimeBlock().apply(
            {"params": p}, a, v))(block_params, jnp.asarray(x),
                                  jnp.asarray(valid))
    block = load_enhancer(NPZ, device="cpu", precise=True).gen.GRUt1
    calls = []

    def spy(seq, *a, **k):
        calls.append(tuple(seq.shape))
        return fused_grouped_gru(seq, *a, **k)

    monkeypatch.setattr(generator, "fused_grouped_gru", spy)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), torch.from_numpy(valid))
    assert calls == [(2, 516, 64)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)

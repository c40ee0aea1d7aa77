"""The port's four kernels as `torch.library` custom ops
(`torch.ops.lct_gan_tpu_torch.*`), on the CPU:

  * `torch.library.opcheck` (schema, fake implementation, autograd
    registration) passes for each op at small shapes and every mode;
  * every mode is an op argument: an exported graph holds the op once, its
    arguments carrying the mode, and the program runs the plain version;
  * a fake CUDA tensor is held to the kernel's shapes at trace time, a
    CPU one (the plain version) is not;
  * on the CPU the public wrappers run their plain versions through the ops
    and count no launch.

Gradients through each op against autograd through its plain version stay
in tests/test_torch_port_ftf_bwd.py, unchanged.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import lct_gan_tpu_torch  # noqa: F401  (registers the ops)
from lct_gan_tpu_torch.export_model import kernel_op_counts
from lct_gan_tpu_torch.ops import (banded_mhsa, fused_ftf_block,
                                   fused_ftf_bwd, fused_mhsa)
from lct_gan_tpu_torch.ops.attention import mhsa_reference
from lct_gan_tpu_torch.ops.ftf import ftf_block_reference

OPS = torch.ops.lct_gan_tpu_torch
CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, scale=0.25):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32))


def ftf_params(rng, bidirectional, C=64):
    D = 2 if bidirectional else 1
    return [1 + _t(rng, C), _t(rng, C), _t(rng, D, 4, 16, 48),
            _t(rng, D, 4, 16, 48), _t(rng, D, 4, 48), _t(rng, D, 4, 48),
            1 + _t(rng, C), _t(rng, C), _t(rng, C, 3 * C), _t(rng, 3 * C),
            _t(rng, C, C), _t(rng, C), _t(rng, 2 * C if bidirectional else C,
                                          C), _t(rng, C)]


def attn_params(rng):
    return [_t(rng, 64, 192), _t(rng, 192), _t(rng, 64, 64), _t(rng, 64)]


def _leaves(tensors):
    return [t.clone().requires_grad_() for t in tensors]


FTF_CASES = [
    # bidirectional, lookback, key_bias, precise
    (True, None, False, False),
    (False, 2, False, True),
    (False, None, True, False),
]


@pytest.mark.parametrize("bidi,lookback,use_kb,precise", FTF_CASES)
def test_opcheck_fused_ftf_block(bidi, lookback, use_kb, precise):
    rng = np.random.default_rng(0)
    N, L = 3, 5
    x = _t(rng, N, L, 64, scale=1.0)
    kb = torch.zeros(N, L) if use_kb else None
    args = (_leaves([x] + ftf_params(rng, bidi))
            + [kb, bidi, 4, lookback, precise])
    torch.library.opcheck(OPS.fused_ftf_block.default, args,
                          test_utils=CHECKS)


@pytest.mark.parametrize("bidi", [True, False])
def test_opcheck_fused_ftf_bwd(bidi):
    rng = np.random.default_rng(1)
    N, L = 3, 5
    D = 2 if bidi else 1
    args = ([_t(rng, N, L, 64, scale=1.0)] + ftf_params(rng, bidi)
            + [_t(rng, D, N * L, 64), _t(rng, N, L, 64), bidi, 4, None,
               False])
    torch.library.opcheck(OPS.fused_ftf_bwd.default, args, test_utils=CHECKS)


ATTN_CASES = [
    # op, lookback, key_bias, precise
    ("fused_mhsa", None, True, False),
    ("fused_mhsa", 3, False, True),
    ("banded_mhsa", 3, True, False),
]


@pytest.mark.parametrize("op,lookback,use_kb,precise", ATTN_CASES)
def test_opcheck_attention(op, lookback, use_kb, precise):
    rng = np.random.default_rng(2)
    N, L = 3, 7
    kb = torch.zeros(N, L) if use_kb else None
    args = (_leaves([_t(rng, N, L, 64, scale=1.0)] + attn_params(rng))
            + [kb, 4, lookback, precise])
    torch.library.opcheck(getattr(OPS, op).default, args, test_utils=CHECKS)


class _Block(torch.nn.Module):
    def __init__(self, params, **kw):
        super().__init__()
        self.params = torch.nn.ParameterList(params)
        self.kw = kw

    def forward(self, x):
        return fused_ftf_block(x, *self.params, **self.kw)


def test_exported_graph_carries_the_mode():
    """One op node, its scalar arguments the call's mode; the program runs
    the plain version of that mode."""
    rng = np.random.default_rng(3)
    x = _t(rng, 4, 6, 64, scale=1.0)
    params = ftf_params(rng, False)
    kw = dict(bidirectional=False, num_heads=4, lookback=2, precise=True)
    program = torch.export.export(_Block(params, **kw), (x,), strict=False)
    assert kernel_op_counts(program) == {"fused_ftf_block": 1}
    node = next(n for n in program.graph.nodes
                if n.target == OPS.fused_ftf_block.default)
    assert list(node.args[15:]) == [None, False, 4, 2, True]
    with torch.inference_mode():
        got = program.module()(x)
        want = ftf_block_reference(x, *params, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fake_cuda_tensors_are_held_to_the_kernel_shapes():
    """At trace time a CUDA tensor must fit the kernel (L <= 1024 for the
    MHSA kernel, C = 64 and L <= 512 for the FTF one); the CPU plain
    version takes any length."""
    with FakeTensorMode():
        p = [torch.empty(t.shape, device="cuda") for t in
             attn_params(np.random.default_rng(4))]
        ok = OPS.fused_mhsa(torch.empty((2, 1024, 64), device="cuda"), *p,
                            None, 4, None, False)
        assert ok.shape == (2, 1024, 64) and ok.device.type == "cuda"
        with pytest.raises(ValueError, match="L <= 1024"):
            OPS.fused_mhsa(torch.empty((2, 1025, 64), device="cuda"), *p,
                           None, 4, None, False)
        cpu = [torch.empty(t.shape) for t in p]
        assert OPS.fused_mhsa(torch.empty((2, 1025, 64)), *cpu, None, 4,
                              None, False).shape == (2, 1025, 64)
        fp = [torch.empty(t.shape, device="cuda") for t in
              ftf_params(np.random.default_rng(5), True)]
        out, hid = OPS.fused_ftf_block(
            torch.empty((3, 33, 64), device="cuda"), *fp, None, True, 4,
            None, False)
        assert out.shape == (3, 33, 64) and hid.shape == (2, 99, 64)
        with pytest.raises(ValueError, match="L <= 512"):
            OPS.fused_ftf_block(torch.empty((3, 513, 64), device="cuda"),
                                *fp, None, True, 4, None, False)


def test_wrappers_run_the_plain_versions_through_the_ops():
    """The public wrappers are the ops: on the CPU their results are the
    plain versions' and no launch is counted."""
    rng = np.random.default_rng(6)
    x = _t(rng, 3, 9, 64, scale=1.0)
    p = attn_params(rng)
    counters = (fused_ftf_block, fused_ftf_bwd, fused_mhsa, banded_mhsa)
    before = [f.launches for f in counters]
    got = fused_mhsa(x, *p, lookback=4, precise=False)
    want = mhsa_reference(x, *p, lookback=4, precise=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    banded_mhsa(x, *p, lookback=4)
    fp = ftf_params(rng, True)
    fused_ftf_bwd(x, *fp, _t(rng, 2, 27, 64), _t(rng, 3, 9, 64),
                  bidirectional=True)
    assert [f.launches for f in counters] == before

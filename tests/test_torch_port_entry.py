"""The port's driver entry point (lct_gan_tpu_torch/entry.py) against
`__graft_entry__.py::entry` on the CPU.

The JAX entry's own PRNGKey(0) weights go through the port's
`entry(device="cpu", params=..., precise=True)`; both `fn`s run on one
seeded 0.1 * N(0, 1) wave of (2, 8000), the JAX one on its jnp path, and
agree within the enhancer tests' ATOL = 1e-4. The example arguments match
in shape, dtype and value; the default device raises without a GPU; the
default weights are `create_state`'s enhancer at seed 0. The data-parallel
dry run behind `python -m lct_gan_tpu_torch.entry` runs in the acceptance
driver's test (stage 5)."""

import importlib.util
import inspect
import os

import numpy as np
import pytest

import jax
import torch

from lct_gan_tpu_torch import entry as port_entry
from lct_gan_tpu_torch.train import TrainConfig, create_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4      # tests/test_torch_port_enhancer.py


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX package's entry() (fn, (wave,)) and its param tree, with its
    persistent compile cache left off (it would move this process's cache
    directory)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LCT_NO_COMPILE_CACHE", "1")
    try:
        spec = importlib.util.spec_from_file_location(
            "_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn, args = mod.entry()
    finally:
        mp.undo()
    params = inspect.getclosurevars(fn).nonlocals["params"]
    return fn, args, jax.tree.map(np.asarray, params)


def _enhancer(fn):
    return inspect.getclosurevars(fn).nonlocals["enhancer"]


def test_entry_matches_the_jax_entry(jax_entry):
    jfn, (jwave,), params = jax_entry
    fn, (wave,) = port_entry.entry(device="cpu", params=params,
                                   precise=True)
    assert tuple(wave.shape) == tuple(jwave.shape) == (8, 32000)
    assert wave.dtype == torch.float32 and jwave.dtype == np.float32
    assert wave.device.type == "cpu"
    assert not wave.any() and not np.asarray(jwave).any()
    x = (0.1 * np.random.default_rng(0).standard_normal((2, 8000))).astype(
        np.float32)
    want = np.asarray(jfn(x))
    got = fn(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 8000)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_entry_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU is visible"):
        port_entry.entry()


def test_entry_default_weights_are_create_states_at_seed_0():
    fn, (wave,) = port_entry.entry(device="cpu")
    state = create_state(TrainConfig(seed=0), device="cpu")
    got = _enhancer(fn).state_dict()
    want = state.enhancer.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    out = fn(wave)
    assert tuple(out.shape) == (8, 32000) and bool(torch.isfinite(out).all())
    assert not out.requires_grad

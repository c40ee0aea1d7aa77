"""The port's serialized-model export (lct_gan_tpu_torch/export_model.py,
export_cli.py) on the CPU, against the JAX package's (lct_gan_tpu/
export_model.py) and against the live enhancer.

  * The portable artifact (every kernel op decomposed into its plain
    version) of the committed demo weights equals the JAX package's
    portable artifact (its jnp path) of the same weights on the same
    seeded input. Both are all-f32 (the port's enhancer precise=True, as
    tests/test_torch_port_enhancer.py compares them); the tolerance is the
    JAX export test's own rtol 2e-4 / atol 1e-6.
  * A keep_kernels artifact traced on the CPU holds the three FTF op nodes
    of the 0.25 s shape and runs the plain versions: equal to the live
    enhancer. Bucket selection, zero padding and trimming, the ValueError
    and meta.json as tests/test_export.py checks them.
  * adaptive_export_shapes equals the JAX package's.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lct_gan_tpu.export_model import adaptive_export_shapes as jax_shapes
from lct_gan_tpu.export_model import export_enhancer as jax_export
from lct_gan_tpu.export_model import load_exported as jax_load
from lct_gan_tpu.train.state import TrainConfig
from lct_gan_tpu_torch import export_cli
from lct_gan_tpu_torch.convert import load_enhancer, read_npz_params
from lct_gan_tpu_torch.export_model import (adaptive_export_shapes,
                                            export_enhancer,
                                            kernel_op_counts, load_exported)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "train_demo", "g_params_best.npz")
PT = os.path.join(ROOT, "artifacts", "train_demo",
                  "enhancer_best_reference_format.pt")
T = 4000   # 0.25 s: the JAX export test's segment


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kept(tmp_path_factory):
    """A keep_kernels artifact of the bf16 (default) enhancer at two
    shapes, traced on the CPU, and the live enhancer."""
    enhancer = load_enhancer(PT, device="cpu")
    path = str(tmp_path_factory.mktemp("kept") / "model.lct.zip")
    seconds = export_enhancer(path, enhancer, [(2, T), (4, 2 * T)],
                              keep_kernels=True)
    return path, enhancer, seconds


def _noise(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_portable_artifact_equals_jax_portable_artifact(tmp_path):
    params, _ = read_npz_params(NPZ)
    cfg = TrainConfig(segment_seconds=0.25, batch_size=2)
    jax_path = str(tmp_path / "jax.lct.zip")
    jax_export(jax_path, jax.tree.map(jnp.asarray, params), cfg, [(2, T)])
    port_path = str(tmp_path / "port.lct.zip")
    export_enhancer(port_path, load_enhancer(NPZ, device="cpu",
                                             precise=True), [(2, T)])
    port = load_exported(port_path, device="cpu")
    assert port.meta["kernels"] is False and port.meta["precise"] is True
    assert kernel_op_counts(port.programs[(2, T)]) == {}
    noisy = _noise((2, T), 0)
    want = jax_load(jax_path)(noisy)
    got = port(noisy)
    assert got.shape == (2, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_keep_kernels_artifact_holds_the_ops_and_equals_the_live_enhancer(
        kept):
    path, enhancer, seconds = kept
    loaded = load_exported(path, device="cpu")
    assert sorted(seconds) == loaded.shapes == [(2, T), (4, 2 * T)]
    for shape in loaded.shapes:
        assert kernel_op_counts(loaded.programs[shape]) == {
            "fused_ftf_block": 3}
    noisy = _noise((2, T), 1)
    with torch.inference_mode():
        want, _ = enhancer(torch.from_numpy(noisy))
    np.testing.assert_allclose(loaded(noisy), want.numpy(), rtol=0,
                               atol=1e-6)


def test_bucket_selection_and_padding(kept):
    path, enhancer, _ = kept
    loaded = load_exported(path, device="cpu")
    small = _noise((1, T - 100), 2)
    out = loaded(small)
    assert out.shape == small.shape
    # The padded input through the live model, trimmed.
    padded = np.zeros((2, T), np.float32)
    padded[:1, :T - 100] = small
    with torch.inference_mode():
        want, _ = enhancer(torch.from_numpy(padded))
    np.testing.assert_allclose(out, want.numpy()[:1, :T - 100], rtol=0,
                               atol=1e-6)
    # Three rows need the (4, 2T) program.
    assert loaded(_noise((3, T), 3)).shape == (3, T)
    with pytest.raises(ValueError, match="no exported shape covers"):
        loaded(_noise((8, 3 * T), 4))


def test_meta_json_fields(kept):
    path, enhancer, _ = kept
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
        meta = json.loads(z.read("meta.json"))
    assert names == ["b2_t4000.pt2", "b4_t8000.pt2", "meta.json"]
    assert meta == {"format": 1, "sample_rate": 16000,
                    "compress_c": pytest.approx(0.3),
                    "max_time_context": None, "kernels": True,
                    "precise": False, "shapes": [[2, T], [4, 2 * T]]}


@pytest.mark.parametrize("lo,hi,kw", [
    (1.5, 10.0, {}),
    (0.5, 30.0, dict(target_batch_seconds=64.0, max_batch=16)),
])
def test_adaptive_export_shapes_equal_the_jax_package(lo, hi, kw):
    assert adaptive_export_shapes(lo, hi, 16000, **kw) == jax_shapes(
        lo, hi, 16000, **kw)


def test_load_exported_refuses_a_missing_card(kept, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU is visible"):
        load_exported(kept[0])


def test_export_cli_writes_the_artifact(tmp_path, capsys):
    """The CLI's flags: weights through load_enhancer (an override that
    differs from the checkpoint's training value warns), the shape table
    from --batch_size x --seconds, --keep_kernels, --device."""
    out = str(tmp_path / "cli.lct.zip")
    with pytest.warns(UserWarning, match="max_time_context=64"):
        export_cli.main(["--checkpoint", NPZ, "--output", out,
                         "--batch_size", "1", "--seconds", "0.25",
                         "--max_time_context", "64", "--keep_kernels",
                         "--device", "cpu"])
    assert "Exported 1 shape(s) [(1, 4000)]" in capsys.readouterr().out
    loaded = load_exported(out, device="cpu")
    assert loaded.meta["max_time_context"] == 64
    assert loaded.meta["kernels"] is True and loaded.shapes == [(1, T)]
    assert loaded(_noise((1, T), 5)).shape == (1, T)

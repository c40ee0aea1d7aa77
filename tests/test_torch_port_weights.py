"""Weight bridge and entry-point rules of the port: both committed weight
files load strictly into identical state dicts; the bridge matches the JAX
package's own exporter; imports pull in no JAX; entry points refuse a
missing GPU instead of falling back to the CPU."""

import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from lct_gan_tpu.convert.torch_export import export_enhancer_state_dict
from lct_gan_tpu_torch.convert import (jax_params_to_state_dict,
                                       load_enhancer, read_npz_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "train_demo", "g_params_best.npz")
PT = os.path.join(ROOT, "artifacts", "train_demo",
                  "enhancer_best_reference_format.pt")


def test_both_weight_files_load_to_identical_state_dicts():
    a = load_enhancer(NPZ, device="cpu").state_dict()
    b = load_enhancer(PT, device="cpu").state_dict()
    assert list(a) == list(b) and len(a) == 131
    for k in a:
        assert torch.equal(a[k], b[k]), k
    n_gen = sum(v.numel() for k, v in a.items() if k.startswith("gen."))
    assert n_gen == 135425
    # float64-computed periodic Hann vs torch's float32 one: last-ulp only.
    torch.testing.assert_close(a["stft.window"], torch.hann_window(512),
                               rtol=2e-6, atol=1e-7)


def test_npz_meta_is_honoured():
    _, meta = read_npz_params(NPZ)
    enh = load_enhancer(NPZ, device="cpu")
    assert enh.c == meta["train_cfg"]["compress_c"] == 0.3
    assert enh.gen.GRUt1.max_time_context is None
    enh = load_enhancer(NPZ, device="cpu", max_time_context=64,
                        compress_c=0.5)
    assert enh.gen.GRUt1.max_time_context == 64 and enh.c == 0.5


@pytest.mark.parametrize("override,warns", [
    ({}, None),
    ({"compress_c": 0.3}, None),              # the training value
    ({"compress_c": 0.5}, r"compress_c=0\.5 differs .* value 0\.3"),
    ({"max_time_context": 64},
     r"max_time_context=64 differs .* value None"),
])
def test_overriding_the_training_config_warns(override, warns):
    """An explicit compress_c or max_time_context that differs from the
    checkpoint's training value changes outputs silently, so it warns (the
    JAX CLI's rule, infer.py:113-132); one that matches does not."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        load_enhancer(NPZ, device="cpu", **override)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]
    if warns is None:
        assert msgs == []
    else:
        assert len(msgs) == 1 and re.search(warns, msgs[0]), msgs


def test_bridge_matches_jax_package_exporter():
    params, _ = read_npz_params(NPZ)
    ours = jax_params_to_state_dict(params)
    theirs = export_enhancer_state_dict(params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        load_enhancer(NPZ)


def test_launch_counters_stay_zero_on_cpu():
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.ops import fused_ftf_block, fused_mhsa

    before = (fused_ftf_block.launches, fused_mhsa.launches)
    enhance = make_enhance(load_enhancer(NPZ, device="cpu"))
    out = enhance(np.zeros((1, 4000), np.float32))
    assert out.shape == (1, 4000) and not out.requires_grad
    assert (fused_ftf_block.launches, fused_mhsa.launches) == before == (0, 0)


def test_import_pulls_in_no_jax():
    code = ("import sys, lct_gan_tpu_torch, lct_gan_tpu_torch.bench, "
            "lct_gan_tpu_torch.infer, lct_gan_tpu_torch.convert, "
            "lct_gan_tpu_torch.models, lct_gan_tpu_torch.data, "
            "lct_gan_tpu_torch.eval, lct_gan_tpu_torch.train, "
            "lct_gan_tpu_torch.losses, lct_gan_tpu_torch.ops.ftf_bwd, "
            "lct_gan_tpu_torch.models.discriminators, "
            "lct_gan_tpu_torch.sigproc.features, "
            "lct_gan_tpu_torch.data.dataset, lct_gan_tpu_torch.metrics, "
            "lct_gan_tpu_torch.utils.config, "
            "lct_gan_tpu_torch.train.checkpoint, "
            "lct_gan_tpu_torch.train.loop, lct_gan_tpu_torch.train_cli, "
            "lct_gan_tpu_torch.export_model, lct_gan_tpu_torch.export_cli, "
            "lct_gan_tpu_torch.eval.compare, lct_gan_tpu_torch.metrics_cli, "
            "lct_gan_tpu_torch.bench_serving_latency\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lct_gan_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """No import of jax, flax or the JAX package anywhere in the port's
    sources (chip_smoke.py included), lazily or not."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "lct_gan_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    walked = {os.path.relpath(f, ROOT) for f in files}
    for rel in ("data/dataset.py", "data/pipeline.py", "utils/config.py",
                "metrics/__init__.py", "metrics/external.py",
                "metrics/sisdr.py", "metrics/stoi.py", "metrics/fwsegsnr.py",
                "metrics/pesq_p862.py", "train/checkpoint.py",
                "train/loop.py", "train_cli.py", "infer.py",
                "export_model.py", "export_cli.py", "eval/compare.py",
                "metrics_cli.py", "bench_serving_latency.py"):
        assert os.path.join("lct_gan_tpu_torch", rel) in walked, rel
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "lct_gan_tpu"), (path, line)

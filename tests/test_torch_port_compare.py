"""The port's experiment harness (lct_gan_tpu_torch/eval/compare.py) on the
CPU: its gates, its spectrogram plot, and `ModelComparator` running the
port's `make_torch_system` beside the JAX package's `make_jax_system` on
the committed demo weights.

The two systems differ only by the port's bf16 rounding points (its
default mode; the JAX system runs its f32 jnp path on the CPU). On the
seeded 0.5 s utterance below their outputs differ by 5.4e-4 of the peak,
their SI-SDR by 4.8e-4 dB and their STOI by 2.8e-4, where the enhancement
itself moves SI-SDR by 10 dB; the bounds are 0.01 dB and 2e-3.
"""

import math
import os

import numpy as np
import pytest
import torch

from lct_gan_tpu.eval import make_jax_system
from lct_gan_tpu_torch.data import write_wav
from lct_gan_tpu_torch.eval import (ModelComparator,
                                    make_deepfilternet_system,
                                    make_torch_reference_system,
                                    make_torch_system, plot_spec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT = os.path.join(ROOT, "artifacts", "train_demo",
                  "enhancer_best_reference_format.pt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deepfilternet_system_gated_with_clear_error():
    try:
        import df.enhance  # noqa: F401

        pytest.skip("df package present; gate not in effect")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="deepfilternet"):
        make_deepfilternet_system()


def test_reference_system_gated_with_clear_error(monkeypatch, tmp_path):
    monkeypatch.delenv("LCT_REFERENCE_ROOT", raising=False)
    with pytest.raises(ImportError, match="LCT_REFERENCE_ROOT"):
        make_torch_reference_system(PT)
    with pytest.raises(ImportError, match="reference repository"):
        make_torch_reference_system(
            PT, reference_root=str(tmp_path / "absent"))


def test_plot_spec_writes_a_png(tmp_path):
    x = (0.1 * np.random.default_rng(0).standard_normal(8000)).astype(
        np.float32)
    p = str(tmp_path / "spec.png")
    plot_spec(x, 16000, "test", p)
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(p) > 5000


def test_comparator_port_and_jax_systems_agree(tmp_path):
    sr = 16000
    rng = np.random.default_rng(1)
    t = np.arange(sr // 2) / sr
    clean = (0.2 * np.sin(2 * np.pi * 440 * t)
             * (0.55 + 0.45 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal(len(t))).astype(np.float32)
    noisy_p, clean_p = str(tmp_path / "noisy.wav"), str(tmp_path / "c.wav")
    write_wav(noisy_p, noisy, sr)
    write_wav(clean_p, clean, sr)

    systems = {"port": make_torch_system(PT, device="cpu"),
               "jax": make_jax_system(PT)}
    result = ModelComparator(systems).process_one_file(
        noisy_p, str(tmp_path / "out"), clean_path=clean_p)

    for name in ("port", "jax"):
        for key in ("dir", "diff_dir", "diff_norm_dir", "diff_plot"):
            assert os.path.exists(result[name][key]), (name, key)
        assert math.isfinite(result[name]["si_sdr"])
    assert os.path.exists(tmp_path / "out" / "spectrograms" / "all.png")
    port, jax_ = result["port"], result["jax"]
    assert abs(port["si_sdr"] - jax_["si_sdr"]) <= 0.01
    assert abs(port["stoi"] - jax_["stoi"]) <= 2e-3
    assert math.isnan(port["pesq"]) == math.isnan(jax_["pesq"])
    # The enhancement itself is far larger than the two systems' gap.
    assert abs(port["si_sdr"] - result["noisy"]["si_sdr"]) > 5.0


def test_comparator_without_plots_writes_wavs_and_metrics(tmp_path):
    """plots=False (a machine without matplotlib): the same wavs and
    metrics, no spectrogram."""
    sr = 16000
    rng = np.random.default_rng(2)
    clean = (0.1 * np.sin(2 * np.pi * 300 * np.arange(sr // 4) / sr)
             ).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal(clean.size)).astype(
        np.float32)
    noisy_p, clean_p = str(tmp_path / "noisy.wav"), str(tmp_path / "c.wav")
    write_wav(noisy_p, noisy, sr)
    write_wav(clean_p, clean, sr)
    out = tmp_path / "out"
    result = ModelComparator({"port": make_torch_system(PT, device="cpu")},
                             plots=False).process_one_file(
        noisy_p, str(out), clean_path=clean_p)
    assert sorted(os.listdir(out)) == ["clean.wav", "noisy.wav", "port.wav",
                                       "port_diff.wav", "port_diff_norm.wav"]
    assert "diff_plot" not in result["port"]
    assert math.isfinite(result["port"]["si_sdr"])

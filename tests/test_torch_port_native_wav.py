"""The port's native wav decoder (lct_gan_tpu_torch/ops/native: wav_io.cc
built by g++ at first use, its ctypes binding, and data/audio_io.py's
load_mono_wave through it) on the CPU:

  * bit-equal to the JAX package's `load_mono_wave_native` on a 48 kHz
    float32 file (resampled to 16 kHz and kept at 48 kHz) and a stereo
    PCM16 file;
  * the port's `load_mono_wave` bit-equal to the JAX package's on the
    48 kHz -> 16 kHz file (the numpy route differs by ~3e-4 there);
  * a file the native parser rejects goes to the numpy route, which raises;
  * a missing or failing compiler raises, with the compiler's output;
  * when the library cannot be built, `load_mono_wave` warns once, runs the
    compiler once, and decodes every file with numpy;
  * loading the library leaves the process's float mode alone (no
    flush-to-zero).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from lct_gan_tpu.data.audio_io import load_mono_wave as jax_load_mono_wave
from lct_gan_tpu.ops.native.wav_loader import \
    load_mono_wave_native as jax_native
from lct_gan_tpu_torch.data import audio_io
from lct_gan_tpu_torch.data import write_wav
from lct_gan_tpu_torch.ops.native import wav_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone(sr, seconds, channels=1):
    t = np.arange(int(sr * seconds)) / sr
    x = np.stack([0.5 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                  + 0.01 * c for c in range(channels)])
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wav")
    out = {"48k_f32": str(d / "a48k.wav"), "stereo_pcm16": str(d / "st.wav")}
    write_wav(out["48k_f32"], _tone(48000, 1.0)[0], 48000, bits=32)
    write_wav(out["stereo_pcm16"], _tone(16000, 0.7, channels=2), 16000)
    return out


@pytest.mark.parametrize("name, target", [
    ("48k_f32", 16000), ("48k_f32", 0), ("stereo_pcm16", 16000),
    ("stereo_pcm16", 0)])
def test_native_decode_is_bit_equal_to_the_jax_package(files, name, target):
    got, sr = wav_loader.load_mono_wave_native(files[name], target)
    want, want_sr = jax_native(files[name], target)
    assert sr == want_sr and got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_load_mono_wave_is_bit_equal_to_the_jax_package_when_resampling(
        files):
    before = (audio_io.load_mono_wave.native_decodes,
              audio_io.load_mono_wave.numpy_decodes)
    got, sr = audio_io.load_mono_wave(files["48k_f32"], 16000)
    want, want_sr = jax_load_mono_wave(files["48k_f32"], 16000)
    assert (sr, want_sr) == (16000, 16000) and len(got) == 16000
    assert np.array_equal(got, want)
    assert (audio_io.load_mono_wave.native_decodes,
            audio_io.load_mono_wave.numpy_decodes) == (before[0] + 1,
                                                       before[1])
    # The plain version (scipy's resample_poly) is another filter sum.
    plain, _ = audio_io.load_mono_wave_numpy(files["48k_f32"], 16000)
    assert 0 < np.abs(plain - got).max() < 1e-3


def test_a_rejected_file_goes_to_the_numpy_reader_which_raises(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVEjunk")
    assert wav_loader.load_mono_wave_native(str(bad), 16000) is None
    before = audio_io.load_mono_wave.numpy_decodes
    with pytest.raises(ValueError, match="Missing fmt/data chunk"):
        audio_io.load_mono_wave(str(bad), 16000)
    assert audio_io.load_mono_wave.numpy_decodes == before + 1


def test_a_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        wav_loader.build_library(compiler=str(tmp_path / "no-such-g++"),
                                 build_dir=str(tmp_path))


def test_a_failing_compiler_raises_with_its_output(tmp_path):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'wav_io.cc:1: error: broken' >&2\n"
                   "exit 3\n")
    cxx.chmod(0o755)
    with pytest.raises(RuntimeError, match="(?s)rc=3.*error: broken"):
        wav_loader.build_library(compiler=str(cxx), build_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["broken-g++"]   # nothing left behind


def test_a_failed_build_falls_back_to_numpy_once_a_process(
        files, tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    runs = tmp_path / "runs"
    cxx = bindir / "g++"
    cxx.write_text(f"#!/bin/sh\necho run >> {runs}\n"
                   "echo 'wav_io.cc:1: error: broken' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(wav_loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(wav_loader, "_lib", None)
    monkeypatch.setattr(wav_loader, "_build_error", None)
    before = (audio_io.load_mono_wave.native_decodes,
              audio_io.load_mono_wave.numpy_decodes)
    with pytest.warns(RuntimeWarning, match="error: broken") as caught:
        got = [audio_io.load_mono_wave(files[name], 16000)
               for name in ("48k_f32", "stereo_pcm16")]
    assert len(caught) == 1
    assert runs.read_text().split() == ["run"]      # g++ ran once
    for (wave, sr), name in zip(got, ("48k_f32", "stereo_pcm16")):
        want, want_sr = audio_io.load_mono_wave_numpy(files[name], 16000)
        assert sr == want_sr == 16000 and wave.dtype == np.float32
        assert np.array_equal(wave, want)
    assert (audio_io.load_mono_wave.native_decodes,
            audio_io.load_mono_wave.numpy_decodes) == (before[0],
                                                       before[1] + 2)


def test_the_library_is_named_by_its_source_and_flags(tmp_path):
    path = wav_loader.build_library(build_dir=str(tmp_path))
    assert os.path.basename(path) == f"libwavio-{wav_loader._tag()}.so"
    mtime = os.path.getmtime(path)
    assert wav_loader.build_library(build_dir=str(tmp_path)) == path
    assert os.path.getmtime(path) == mtime      # reused, not rebuilt


def test_loading_the_library_leaves_flush_to_zero_off():
    """-ffast-math at link time would put crtfastmath's constructor in the
    library, which turns on flush-to-zero in the process that loads it."""
    code = ("import numpy as np\n"
            "from lct_gan_tpu_torch.ops.native import wav_loader\n"
            "wav_loader._get_lib()\n"
            "tiny = np.float32(1e-40)\n"
            "print(float(tiny * np.float32(1.0)) != 0.0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "True"

"""Experiment harness: several enhancement systems on one utterance
(`lct_gan_tpu/eval/compare.py`; the reference's `ModelComparator`,
`plot_spec*`, Experiments/util.py:28-657).

Runs any number of systems on one noisy file and writes, per system: the
enhanced wav, a dB spectrogram PNG, clean-minus-estimate diff artifacts
(raw and peak-normalised wav, diff spectrogram) and a metrics dict (SI-SDR
/ PESQ / STOI against clean). Systems are plain callables `wave[np.float32
[T]] -> wave[np [T]]`; `make_torch_system` builds one from the port's
weights on the card, the other helpers the reference's PyTorch model and
DeepFilterNet, both gated as in the JAX package.

Plotting is matplotlib only (Agg): spectrograms use the port's STFT
(512 / 256 hann, the geometry of util.py:197-211) in dB re max, with one
color scale across stacked panels, as the reference plots them.
"""

from __future__ import annotations

import math
import os
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ModelComparator",
    "plot_spec",
    "plot_specs_stack",
    "plot_specs_triptych",
    "make_deepfilternet_system",
    "make_torch_system",
    "make_torch_reference_system",
]

System = Callable[[np.ndarray], np.ndarray]

# Where make_torch_reference_system finds the reference repository (its
# models/ and datasets/ packages) unless the caller names it.
REFERENCE_ROOT_ENV = "LCT_REFERENCE_ROOT"


def _mag_db(x: np.ndarray, n_fft=512, hop=256) -> np.ndarray:
    """|STFT| in dB re max (librosa.amplitude_to_db(ref=np.max) equiv)."""
    import torch

    from lct_gan_tpu_torch.sigproc import STFTConfig, stft

    with torch.inference_mode():
        spec = stft(torch.from_numpy(x[None].astype(np.float32)),
                    STFTConfig(n_fft=n_fft, hop_length=hop))[0].numpy()
    mag = np.maximum(np.abs(spec), 1e-10)
    db = 20.0 * np.log10(mag)
    return np.maximum(db - db.max(), -80.0)


def plot_spec(x: np.ndarray, sr: int = 16000, title: str = "",
              save_path: Optional[str] = None, dpi: int = 150) -> None:
    """Single dB spectrogram (reference: util.py:97-135)."""
    plot_specs_stack([(title, x)], sr=sr, save_path=save_path, dpi=dpi)


def plot_specs_stack(panels: Sequence[Tuple[str, np.ndarray]],
                     sr: int = 16000, save_path: Optional[str] = None,
                     dpi: int = 150) -> None:
    """Vertical stack of spectrograms with a shared color scale and
    per-panel colorbars (reference: util.py:28-94)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    if not panels:
        return
    specs = [(t, _mag_db(np.asarray(w).reshape(-1))) for t, w in panels]
    vmin = min(s.min() for _, s in specs)
    vmax = max(s.max() for _, s in specs)

    fig, axes = plt.subplots(
        nrows=len(specs), ncols=1, figsize=(11, 3.0 * len(specs)),
        sharex=True, sharey=True, constrained_layout=True)
    if len(specs) == 1:
        axes = [axes]

    hop = 256
    for ax, (title, S) in zip(axes, specs):
        n_f, n_t = S.shape
        extent = (0, n_t * hop / sr, 0, sr / 2 / 1000)
        img = ax.imshow(S, origin="lower", aspect="auto", extent=extent,
                        vmin=vmin, vmax=vmax, cmap="magma")
        ax.set_title(title)
        ax.set_ylabel("kHz")
        divider = make_axes_locatable(ax)
        cax = divider.append_axes("right", size="2.5%", pad=0.15)
        fig.colorbar(img, cax=cax, format="%+2.0f dB")
    axes[-1].set_xlabel("time (s)")

    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def plot_specs_triptych(noisy, ftf=None, dfn=None, clean=None, my_ftf=None,
                        sr: int = 16000, save_path: Optional[str] = None,
                        dpi: int = 150) -> None:
    """Clean/noisy/systems comparison stack (reference: util.py:138-166)."""
    panels: List[Tuple[str, np.ndarray]] = []
    if clean is not None:
        panels.append(("Clean (16 kHz)", clean))
    panels.append(("Noisy (16 kHz)", noisy))
    if ftf is not None:
        panels.append(("LCT-GAN", ftf))
    if my_ftf is not None:
        panels.append(("FTFNet", my_ftf))
    if dfn is not None:
        panels.append(("DeepFilterNet (48 to 16 kHz)", dfn))
    plot_specs_stack(panels, sr=sr, save_path=save_path, dpi=dpi)


def make_torch_system(checkpoint: str, compress_c: float = 0.3,
                      device="cuda") -> System:
    """System callable from the port's weights (a generator `.npz` or a
    reference-format `.pt`, through `load_enhancer` and `make_enhance`; the
    counterpart of `make_jax_system`), on the card unless device="cpu"."""
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.eval.serve import make_enhance

    enhance = make_enhance(load_enhancer(checkpoint, device=device,
                                         compress_c=compress_c))

    def system(wave: np.ndarray) -> np.ndarray:
        return enhance(wave[None].astype(np.float32))[0].cpu().numpy()

    return system


def _import_reference_generator(root: Optional[str]):
    """The reference repository's `models.generator`, imported with `root`
    first on sys.path (the few lines of the JAX package's test helper
    `tests/_reference.py::import_reference` this needs)."""
    import importlib
    import types

    root = root or os.environ.get(REFERENCE_ROOT_ENV)
    if not root or not os.path.isdir(root):
        raise ImportError(
            "The reference PyTorch comparison needs the reference "
            "repository: pass reference_root or set "
            f"{REFERENCE_ROOT_ENV} to its directory (got {root!r}).")
    if root not in sys.path:
        sys.path.insert(0, root)
    # The reference's 'datasets' package may collide with an installed
    # 'datasets' (HuggingFace): drop any other one.
    for mod in list(sys.modules):
        if mod == "datasets" or mod.startswith("datasets."):
            path = getattr(sys.modules[mod], "__file__", "") or ""
            if root not in path:
                del sys.modules[mod]
    # Its datasets/__init__.py imports torchaudio (eval only there).
    if "torchaudio" not in sys.modules:
        ta = types.ModuleType("torchaudio")
        ta.functional = types.ModuleType("torchaudio.functional")
        ta.load = None
        sys.modules["torchaudio"] = ta
        sys.modules["torchaudio.functional"] = ta.functional
    return importlib.import_module("models.generator")


def make_torch_reference_system(checkpoint: str, compress_c: float = 0.3,
                                reference_root: Optional[str] = None
                                ) -> System:
    """System callable running the REFERENCE PyTorch LCTEnhancer on the CPU
    (for side-by-side parity runs). Needs the reference repository, at
    `reference_root` or `$LCT_REFERENCE_ROOT`; raises ImportError without
    it."""
    import torch

    gen_mod = _import_reference_generator(reference_root)
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
    enh = gen_mod.LCTEnhancer(gen_cfg=gen_mod.LCTGeneratorConfig(),
                              c=compress_c).eval()
    enh.load_state_dict(ckpt["enhancer"] if "enhancer" in ckpt else ckpt,
                        strict=True)

    def system(wave: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out, _ = enh(torch.from_numpy(wave[None].astype(np.float32)))
        return out[0].numpy()

    return system


def make_deepfilternet_system(sample_rate: int = 16000) -> System:
    """DeepFilterNet3 comparison system (reference: run_deepfilternet,
    Experiments/util.py:388-393): resample to DFN's native 48 kHz, enhance,
    resample back.

    Needs the `df` package; without it this raises a clear ImportError at
    once (not a confusing failure at enhancement time). With the package
    the same code path is the working comparison:

        systems = {"ours": make_torch_system(ckpt),
                   "dfn": make_deepfilternet_system()}
        ModelComparator(systems).process_one_file(noisy_wav, out_dir)
    """
    try:
        from df.enhance import enhance, init_df
    except ImportError as e:
        raise ImportError(
            "DeepFilterNet comparison requires the `df` package, which is "
            "not installed in this image. Install with `pip install "
            "deepfilternet` (pulls torch + model weights) and re-run. All "
            "other ModelComparator systems work without it.") from e
    import torch

    from lct_gan_tpu_torch.data.audio_io import resample

    model, df_state, _ = init_df()
    df_sr = df_state.sr()  # 48000

    def system(wave: np.ndarray) -> np.ndarray:
        hi = resample(wave.astype(np.float32), sample_rate, df_sr)
        out = enhance(model, df_state, torch.from_numpy(hi[None]))
        out = out.squeeze(0).numpy()
        return resample(out, df_sr, sample_rate)[:len(wave)]

    return system


class ModelComparator:
    """Run systems on one noisy file; write wavs, spectrograms, diff
    artifacts, metrics (reference: ModelComparator.process_one_file,
    util.py:395-657). plots=False writes no spectrogram PNG (for a machine
    without matplotlib); wavs and metrics are the same."""

    def __init__(self, systems: Dict[str, System],
                 metrics_sr: int = 16000, metrics_estoi: bool = False,
                 plots: bool = True):
        self.systems = systems
        self.metrics_sr = metrics_sr
        self.metrics_estoi = metrics_estoi
        self.plots = plots

    def _plot(self, wave: np.ndarray, title: str, path: Path) -> None:
        if self.plots:
            plot_spec(wave, self.metrics_sr, title, str(path))

    def _metrics(self, clean: np.ndarray, est: np.ndarray) -> Dict:
        from lct_gan_tpu_torch.metrics import pesq_score, si_sdr, stoi_score

        n = min(len(clean), len(est))
        out = {"si_sdr": si_sdr(clean[:n], est[:n])}
        try:
            out["pesq"] = pesq_score(clean[:n], est[:n], self.metrics_sr)
        except Exception:
            out["pesq"] = math.nan
        try:
            out["stoi"] = stoi_score(clean[:n], est[:n], self.metrics_sr,
                                     extended=self.metrics_estoi)
        except Exception:
            out["stoi"] = math.nan
        return out

    def process_one_file(self, noisy_path: str, out_dir: str,
                         clean_path: Optional[str] = None) -> Dict:
        from lct_gan_tpu_torch.data import load_mono_wave, write_wav

        out = Path(out_dir)
        spec_dir = out / "spectrograms"
        out.mkdir(parents=True, exist_ok=True)
        if self.plots:
            spec_dir.mkdir(parents=True, exist_ok=True)

        noisy, _ = load_mono_wave(noisy_path, self.metrics_sr)
        noisy = np.clip(noisy, -1.0, 1.0)
        write_wav(str(out / "noisy.wav"), noisy, self.metrics_sr)
        self._plot(noisy, "Noisy (16 kHz)", spec_dir / "noisy.png")

        clean = None
        if clean_path is not None:
            clean, _ = load_mono_wave(clean_path, self.metrics_sr)
            clean = np.clip(clean, -1.0, 1.0)
            write_wav(str(out / "clean.wav"), clean, self.metrics_sr)
            self._plot(clean, "Clean (16 kHz)", spec_dir / "clean.png")

        result: Dict = {
            "clean": {"dir": str(out / "clean.wav") if clean is not None
                      else None},
            "noisy": {"dir": str(out / "noisy.wav")},
        }
        if clean is not None:
            result["noisy"].update(self._metrics(clean, noisy))

        panels: List[Tuple[str, np.ndarray]] = [("Noisy", noisy)]
        if clean is not None:
            panels.insert(0, ("Clean", clean))

        for name, system in self.systems.items():
            est = np.clip(system(noisy), -1.0, 1.0)
            wav_path = out / f"{name}.wav"
            write_wav(str(wav_path), est, self.metrics_sr)
            self._plot(est, name, spec_dir / f"{name}.png")
            panels.append((name, est))
            entry: Dict = {"dir": str(wav_path)}
            if clean is not None:
                entry.update(self._metrics(clean, est))
                entry.update(self._save_diff_artifacts(
                    name, clean, est, out, spec_dir))
            result[name] = entry

        if self.plots:
            plot_specs_stack(panels, self.metrics_sr,
                             str(spec_dir / "all.png"))
        return result

    def _save_diff_artifacts(self, tag: str, clean: np.ndarray,
                             est: np.ndarray, out_dir: Path,
                             spec_dir: Path, eps: float = 1e-9) -> Dict:
        """clean-minus-estimate listening/visual artifacts
        (reference: util.py:236-273)."""
        from lct_gan_tpu_torch.data import write_wav

        n = min(len(clean), len(est))
        diff = np.clip(clean[:n] - est[:n], -1.0, 1.0)
        diff_wav = out_dir / f"{tag}_diff.wav"
        write_wav(str(diff_wav), diff, self.metrics_sr)
        res = {"diff_dir": str(diff_wav)}
        if self.plots:
            diff_png = spec_dir / f"{tag}_diff.png"
            plot_spec(diff, self.metrics_sr, f"Diff (clean - {tag})",
                      str(diff_png))
            res["diff_plot"] = str(diff_png)

        peak = float(np.abs(diff).max())
        if peak > eps:
            diff_norm = np.clip(diff / peak * 0.99, -1.0, 1.0)
        else:
            diff_norm = diff
        norm_path = out_dir / f"{tag}_diff_norm.wav"
        write_wav(str(norm_path), diff_norm, self.metrics_sr)
        res["diff_norm_dir"] = str(norm_path)
        return res

"""The port's metrics CLI (lct_gan_tpu_torch/metrics_cli.py) against the JAX
package's `metrics.py`, and the serving-latency tool's formulas and chunk
check (lct_gan_tpu_torch/bench_serving_latency.py), on the CPU. Nothing is
timed here: the tool measures on the card only."""

import os
import runpy
import sys

import numpy as np
import pytest

from lct_gan_tpu_torch import bench_serving_latency as bsl
from lct_gan_tpu_torch import metrics_cli
from lct_gan_tpu_torch.data import write_wav
from lct_gan_tpu_torch.eval.streaming import chunk_geometry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _corpus(root, missing=False):
    """3 test utterances (clean, and an 'enhanced' clean + noise) of
    0.4-0.6 s; with `missing`, the last one's enhanced file is absent."""
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(root, "clean_test"))
    os.makedirs(os.path.join(root, "enh"))
    ids = [f"u{i}" for i in range(3)]
    for i, uid in enumerate(ids):
        t = np.arange(int((0.4 + 0.1 * i) * SR)) / SR
        clean = 0.2 * np.sin(2 * np.pi * (150 + 60 * i) * t) * (
            0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        enh = clean + (0.02 + 0.02 * i) * rng.standard_normal(t.size)
        write_wav(os.path.join(root, "clean_test", f"{uid}.wav"),
                  clean.astype(np.float32), SR)
        if not (missing and i == 2):
            write_wav(os.path.join(root, "enh", f"{uid}.wav"),
                      enh.astype(np.float32), SR)
    with open(os.path.join(root, "test.scp"), "w") as f:
        f.write("\n".join(ids) + "\n")


@pytest.mark.parametrize("missing", [False, True])
def test_metrics_cli_prints_the_jax_clis_lines(tmp_path, capsys, monkeypatch,
                                               missing):
    _corpus(str(tmp_path), missing)
    argv = ["--data_root", str(tmp_path), "--enhanced_dir",
            str(tmp_path / "enh"), "--no_pesq"]
    metrics_cli.main(argv)
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["metrics.py", *argv])
    runpy.run_path(os.path.join(ROOT, "metrics.py"), run_name="__main__")
    theirs = capsys.readouterr().out.splitlines()
    assert ours == theirs
    warnings = [line for line in ours if line.startswith("WARNING")]
    assert warnings == (["WARNING: missing files for u2, skipping"]
                        if missing else [])
    rest = ours[len(warnings):]
    assert rest[0] == f"Evaluated {2 if missing else 3}/3 utterances"
    assert [line.split(":")[0] for line in rest[1:]] == ["fwsegsnr",
                                                         "si_sdr", "stoi"]


def test_latency_formulas():
    # A 4 s chunk with 0.5 s overlap brings 3.5 s of new audio.
    assert bsl.streaming_rtf(4.0, 0.5, 35.0) == pytest.approx(100.0)
    assert bsl.seam_latency_ms(4.0, 35.0) == pytest.approx(4035.0)
    assert bsl.one_shot_rtf(2.0, 20.0) == pytest.approx(100.0)


@pytest.mark.parametrize("chunk,overlap,ok", [
    (0.5, 0.5, False), (0.9, 0.5, False), (1.0, 0.5, True),
    (4.0, 0.5, True), (2.0, 1.0, True)])
def test_chunk_check_is_enhance_in_chunks_rule(chunk, overlap, ok):
    if ok:
        assert chunk_geometry(chunk, overlap, SR) == (int(chunk * SR),
                                                      int(overlap * SR))
    else:
        with pytest.raises(ValueError, match="at most half the chunk"):
            chunk_geometry(chunk, overlap, SR)


def test_latency_tool_refuses_a_bad_chunk_before_timing():
    calls = []
    with pytest.raises(ValueError, match="at most half the chunk"):
        bsl.measure(calls.append, [2.0], [1.0, 0.5], 0.5)
    assert calls == []
    defaults = bsl.parse_args([])
    assert 0.5 not in defaults.chunk_seconds
    for ch in defaults.chunk_seconds:
        chunk_geometry(ch, defaults.overlap_seconds, SR)

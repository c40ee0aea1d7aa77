"""The port's data layer, bench workloads and infer CLI on the CPU: the
bucketing copies agree with the JAX package's, the wav reader/writer
round-trips, the --full workload batches exactly as bench.py does, and the
infer CLI keeps infer.py's wav-in/wav-out contract."""

import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from lct_gan_tpu.data import adaptive_slices as jax_adaptive_slices
from lct_gan_tpu.data import bucket_length as jax_bucket_length
from lct_gan_tpu.data import read_wav as jax_read_wav
from lct_gan_tpu_torch import bench as port_bench
from lct_gan_tpu_torch import infer as port_infer
from lct_gan_tpu_torch.convert import load_enhancer
from lct_gan_tpu_torch.data import (adaptive_slices, bucket_length,
                                    bucketed_batches, read_wav, write_wav)
from lct_gan_tpu_torch.eval import make_enhance

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "train_demo", "g_params_best.npz")


def test_bucketing_matches_jax_package():
    for n in list(range(1, 70000, 997)) + [131072, 131073, 163840, 163841]:
        assert bucket_length(n) == jax_bucket_length(n)
    rng = np.random.default_rng(0)
    lens = sorted(rng.integers(8000, 200000, size=300).tolist())
    for target, cap in ((128 * 32000, 128), (64000, 4), (10 ** 7, 1000)):
        assert (adaptive_slices(lens, target, cap)
                == jax_adaptive_slices(lens, target, cap))


def test_full_workload_batches_as_jax_bench():
    batches, total = port_bench.full_batches()
    chunks = jax_bench.full_batch_chunks(jax_bench.full_utterance_lengths())
    assert [b[1].tolist() for b in batches] == chunks
    assert [b[0].shape[1] for b in batches] == [
        jax_bucket_length(max(c)) for c in chunks]
    assert total == pytest.approx(sum(map(sum, chunks)) / 16000)


@pytest.mark.parametrize("bits", [16, 32])
def test_wav_round_trip(tmp_path, bits):
    x = np.random.default_rng(1).uniform(-0.9, 0.9, (2, 1000)).astype(
        np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, x, 16000, bits=bits)
    got, sr = read_wav(path)
    want, sr2 = jax_read_wav(path)
    assert sr == sr2 == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=1.0 / 32768 if bits == 16 else 0)


def test_bucketed_batches_cover_every_utterance():
    rng = np.random.default_rng(2)
    waves = {f"u{i}": rng.standard_normal(n).astype(np.float32)
             for i, n in enumerate([5000, 20000, 17000, 40000, 16384])}
    ids = list(waves)
    seen = []
    for b in bucketed_batches(ids, waves, 2, 64000):
        assert b["noisy"].shape[1] == bucket_length(int(b["lengths"].max()))
        for i, uid in enumerate(b["id"]):
            n = int(b["lengths"][i])
            np.testing.assert_array_equal(b["noisy"][i, :n], waves[uid])
            assert not b["noisy"][i, n:].any()
        seen += b["id"]
    assert sorted(seen) == sorted(ids)
    exact = list(bucketed_batches(ids, waves, 2, None))
    assert [b["noisy"].shape for b in exact] == [(1, waves[u].size)
                                                 for u in ids]


def _make_tree(root, lens, sr=16000):
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "noisy_test"))
    waves = {}
    for i, n in enumerate(lens):
        t = np.arange(n) / sr
        w = (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(os.path.join(root, "noisy_test", f"utt{i}.wav"), w, sr)
        waves[f"utt{i}"] = read_wav(
            os.path.join(root, "noisy_test", f"utt{i}.wav"))[0][0]
    with open(os.path.join(root, "test.scp"), "w") as f:
        f.write("# test set\n" + "\n".join(waves) + "\n\n")
    return waves


def test_infer_cli_contract(tmp_path):
    root = str(tmp_path / "data")
    waves = _make_tree(root, [4000, 7000, 5500])
    enhance = make_enhance(load_enhancer(NPZ, device="cpu"))
    common = ["--data_root", root, "--checkpoint", NPZ, "--device", "cpu"]

    out = str(tmp_path / "bucketed")
    port_infer.main(common + ["--output_dir", out])
    for uid, w in waves.items():
        got, sr = read_wav(os.path.join(out, f"{uid}.wav"))
        assert sr == 16000 and got.shape == (1, w.size)

    out = str(tmp_path / "exact")
    port_infer.main(common + ["--output_dir", out, "--exact_lengths"])
    for uid, w in waves.items():
        got, _ = read_wav(os.path.join(out, f"{uid}.wav"))
        want = enhance(w[None]).numpy()
        np.testing.assert_allclose(got[0], want[0], atol=1.0 / 32768 + 1e-6)

    out = str(tmp_path / "padded")
    port_infer.main(common + ["--output_dir", out, "--pad_outputs"])
    for uid in waves:
        got, _ = read_wav(os.path.join(out, f"{uid}.wav"))
        assert got.shape == (1, bucket_length(7000))

    # Chunked mode keeps the streaming geometry check: overlap <= chunk/2.
    with pytest.raises(ValueError, match="at most half the chunk"):
        port_infer.main(common + ["--output_dir", out,
                                  "--chunk_seconds", "1.0",
                                  "--chunk_overlap", "0.6"])


def test_bench_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_bench.run(False, NPZ, "cuda")

"""The port's data layer, bench workloads and infer CLI on the CPU: the
bucketing copies agree with the JAX package's, and so do the header length
probe, the dataset's crops and every batch the training, validation and
inference batchers yield (exactly); the prefetcher places batches and
surfaces errors; the wav reader/writer round-trips; the --full workload
batches exactly as bench.py does; and the infer CLI keeps infer.py's
wav-in/wav-out contract."""

import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from lct_gan_tpu.data import ScpDataset as JaxScpDataset
from lct_gan_tpu.data import adaptive_slices as jax_adaptive_slices
from lct_gan_tpu.data import batch_iterator as jax_batch_iterator
from lct_gan_tpu.data import bucket_length as jax_bucket_length
from lct_gan_tpu.data import read_wav as jax_read_wav
from lct_gan_tpu.data.audio_io import wav_num_samples as jax_wav_num_samples
from lct_gan_tpu_torch import bench as port_bench
from lct_gan_tpu_torch import infer as port_infer
from lct_gan_tpu_torch.convert import load_enhancer
from lct_gan_tpu_torch.data import (Prefetcher, ScpDataset, adaptive_slices,
                                    batch_iterator, bucket_length, read_wav,
                                    wav_num_samples, write_wav)
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


def test_bucketed_batches_cover_every_utterance(tmp_path):
    """The infer CLI's batching: batch_iterator over the noisy side of a
    test set, adaptive bucketed batches and exact-length ones."""
    lens = [5000, 20000, 17000, 40000, 16384]
    waves = _make_tree(str(tmp_path), lens)
    ds = ScpDataset(str(tmp_path), "test.scp", "test", segment_length=None,
                    random_segment=False, load_clean=False)
    ids = list(waves)
    seen = []
    for b in batch_iterator(ds, 2, bucket=True, sort_by_length=True,
                            adaptive_target_samples=64000):
        assert b["noisy"].shape[1] == bucket_length(int(b["lengths"].max()))
        for i, uid in enumerate(b["id"]):
            n = int(b["lengths"][i])
            np.testing.assert_array_equal(b["noisy"][i, :n], waves[uid])
            assert not b["noisy"][i, n:].any()
        seen += b["id"]
    assert sorted(seen) == sorted(ids)
    exact = list(batch_iterator(ds, 1))
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


@pytest.mark.parametrize("flags", [
    ["--no_sort_by_length", "--batch_size", "2", "--num_workers", "0"],
    ["--num_workers", "1"]])
def test_infer_cli_batchings_agree(tmp_path, flags):
    """Scp-order fixed batches and decode-thread counts give the outputs
    of the default length-sorted adaptive batching (every utterance lands
    in the same 16,384-sample bucket, rows are independent)."""
    root = str(tmp_path / "data")
    waves = _make_tree(root, [4000, 7000, 5500, 9000])
    common = ["--data_root", root, "--checkpoint", NPZ, "--device", "cpu"]
    port_infer.main(common + ["--output_dir", str(tmp_path / "a")])
    port_infer.main(common + ["--output_dir", str(tmp_path / "b")] + flags)
    for uid, w in waves.items():
        a, _ = read_wav(str(tmp_path / "a" / f"{uid}.wav"))
        b, _ = read_wav(str(tmp_path / "b" / f"{uid}.wav"))
        assert a.shape == b.shape == (1, w.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 32768 + 1e-6)


def test_bench_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_bench.run(False, NPZ, "cuda")


def _make_pairs(root, n_train=8, n_test=5, sr=16000):
    """Paired clean / noisy wavs of 0.3-0.8 s in the repo's layout (the
    JAX package's tests' tree), with a comment line in the scp files."""
    rng = np.random.default_rng(4)
    for split, n in (("train", n_train), ("test", n_test)):
        ids = []
        for sub in ("clean", "noisy"):
            os.makedirs(os.path.join(root, f"{sub}_{split}"), exist_ok=True)
        for i in range(n):
            uid = f"{split}{i:03d}"
            T = int(sr * (0.3 + 0.5 * i / (n - 1)))
            clean = (0.1 * rng.standard_normal(T)).astype(np.float32)
            noisy = clean + (0.05 * rng.standard_normal(T)).astype(np.float32)
            write_wav(os.path.join(root, f"clean_{split}", f"{uid}.wav"),
                      clean, sr)
            write_wav(os.path.join(root, f"noisy_{split}", f"{uid}.wav"),
                      noisy, sr)
            ids.append(uid)
        with open(os.path.join(root, f"{split}.scp"), "w") as f:
            f.write("# ids\n" + "\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pairs"))
    _make_pairs(root)
    return root


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert list(g["id"]) == list(w["id"])
        for k in ("noisy", "clean", "lengths"):
            if k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("sr_file,channels,target", [
    (16000, 1, None), (16000, 1, 16000), (44100, 1, 16000),
    (8000, 2, 16000), (48000, 2, 22050)])
def test_wav_num_samples_matches_jax(tmp_path, sr_file, channels, target):
    path = str(tmp_path / "a.wav")
    x = np.random.default_rng(5).uniform(-0.5, 0.5, (channels, 12345))
    write_wav(path, x.astype(np.float32), sr_file)
    assert (wav_num_samples(path, target)
            == jax_wav_num_samples(path, target))


@pytest.mark.parametrize("load_clean", [True, False])
def test_dataset_crops_match_jax_and_repeat_on_resume(pairs, load_clean):
    kw = dict(sample_rate=16000, segment_length=6000, random_segment=True,
              seed=7, load_clean=load_clean)
    port = ScpDataset(pairs, "train.scp", "train", **kw)
    ref = JaxScpDataset(pairs, "train.scp", "train", **kw)
    assert port.utt_ids == ref.utt_ids and len(port) == 8
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        fresh = ScpDataset(pairs, "train.scp", "train", **kw)
        fresh.set_epoch(epoch)  # a resumed run's dataset
        for i in range(len(port)):
            a, b, c = port[i], ref[i], fresh[i]
            assert a.keys() == b.keys() == c.keys()
            for k in ("noisy", "clean"):
                if k in b:
                    np.testing.assert_array_equal(a[k], b[k])
                    np.testing.assert_array_equal(c[k], b[k])
            assert port.num_samples(i) == ref.num_samples(i)


@pytest.mark.parametrize("case", [
    "train", "train_workers", "bucket_sorted_adaptive", "bucket_sorted",
    "bucket_scp_order", "infer_noisy_only"])
def test_batch_iterator_matches_jax(pairs, case):
    """Batches (ids, noisy, clean, lengths) equal the JAX package's at
    epochs 1 and 2: the training batcher (shuffle, drop_last,
    pad_to_segment, keyed on seed and epoch; also with decode threads) and
    the validation / inference batchers (buckets, length sort, adaptive
    row counts)."""
    train = case.startswith("train")
    split = "train" if train else "test"
    kw = dict(sample_rate=16000, segment_length=4000 if train else None,
              random_segment=train, seed=3,
              load_clean=case != "infer_noisy_only")
    port = ScpDataset(pairs, f"{split}.scp", split, **kw)
    ref = JaxScpDataset(pairs, f"{split}.scp", split, **kw)
    if train:
        it = dict(shuffle=True, drop_last=True, pad_to_segment=True, seed=3,
                  num_workers=2 if case == "train_workers" else 0)
        bs = 3
    else:
        it = dict(bucket=True, sort_by_length=case != "bucket_scp_order",
                  adaptive_target_samples=(3 * 16384 if "adaptive" in case
                                           or case == "infer_noisy_only"
                                           else None))
        bs = 2
    for epoch in (1, 2):
        _same_batches(batch_iterator(port, bs, epoch=epoch, **it),
                      jax_batch_iterator(ref, bs, epoch=epoch, **it))
    if train:
        # drop_last: 8 utterances at 3 per batch -> 2 full batches.
        assert [b["noisy"].shape for b in batch_iterator(
            port, bs, epoch=1, **it)] == [(3, 4000)] * 2


def test_prefetcher_places_batches_and_surfaces_errors():
    batches = [{"noisy": np.full((2, 4), i, np.float32),
                "clean": np.zeros((2, 4), np.float32),
                "lengths": np.asarray([4, 3])} for i in range(3)]
    got = list(Prefetcher(iter(batches), depth=2, device="cpu"))
    assert [float(b["noisy"][0, 0]) for b in got] == [0.0, 1.0, 2.0]
    assert all(isinstance(b["noisy"], torch.Tensor)
               and isinstance(b["clean"], torch.Tensor)
               and isinstance(b["lengths"], np.ndarray) for b in got)
    # Without a device the batches pass through unchanged.
    same = list(Prefetcher(iter(batches), depth=1))
    assert all(a is b for a, b in zip(same, batches))

    def broken():
        yield batches[0]
        raise OSError("decode failed")

    it = Prefetcher(broken(), depth=2, device="cpu")
    next(it)
    with pytest.raises(OSError, match="decode failed"):
        next(it)

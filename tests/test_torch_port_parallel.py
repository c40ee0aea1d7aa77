"""The port's data parallelism (lct_gan_tpu_torch/parallel, the sharded
train step and validation, batch_iterator(shard=...), train_cli
--data_parallel) on the CPU: 2 ranks over gloo started by `parallel.spawn`
(the spawn start method, a file:// rendezvous in a temporary directory, one
torch thread a rank), TrainConfig(segment_seconds=0.25):

  (a) the 2-rank step (global B = 4) against the 1-rank step, all-f32
      (`parallel.dryrun`): metrics rtol 2e-4 atol 1e-6, parameters rtol
      1e-3 atol 2e-6 (tests/test_train_step.py:274-287), and the ranks
      bit-equal after every step;
  (b) the same run against the JAX package's step over a 2-device mesh
      (the conftest's forced CPU devices) from one JAX `create_state`
      carried across by convert/weights.py: metrics of steps 1-3 rtol 1e-4
      (tests/test_torch_port_train_step.py:103), and step 1's all-reduced
      gradients against jax.grad of the global batch's losses, 1e-3 of each
      tensor's largest magnitude (the same file's line 171);
  (c) sharded `validate` (batch_multiple 2, adaptive and fixed batches, with
      STOI) against 1-rank validation (tests/test_train_step.py:400-404:
      rtol 2e-4 atol 1e-5);
  (d) batch_iterator's shards put together equal the 1-rank batches bit for
      bit, each rank decoding only its rows;
  (e) the G clip runs after the all-reduce: with a clip that always
      triggers, the gradients G's optimizer consumes equal the 1-rank
      step's (clipping each rank's half first gives another vector);
  (g) train_cli --data_parallel 2 --device cpu, the ranks started by the
      CLI or by torchrun: one run directory, one set of checkpoints, one
      metrics.csv row, validation equal to the 1-rank validation of the
      saved weights;
and the mesh's own rules (world 1 is the identity, the backend rule,
shard_batch, a failing rank's traceback).
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lct_gan_tpu.parallel import batch_sharding as jax_batch_sharding
from lct_gan_tpu.parallel import make_mesh as jax_make_mesh
from lct_gan_tpu.parallel import replicated_sharding as jax_replicated
from lct_gan_tpu.train.state import TrainConfig as JaxTrainConfig
from lct_gan_tpu.train.state import create_state as jax_create_state
from lct_gan_tpu.train.step import make_train_step as jax_make_train_step
from lct_gan_tpu_torch import train_cli
from lct_gan_tpu_torch.convert import (jax_disc_params_to_state_dict,
                                       jax_params_to_state_dict,
                                       load_enhancer)
from lct_gan_tpu_torch.data import ScpDataset, batch_iterator, write_wav
from lct_gan_tpu_torch.parallel import (Mesh, all_reduce_mean_,
                                        broadcast_state_, make_mesh,
                                        replicas_equal, shard_batch, spawn)
from lct_gan_tpu_torch.parallel import dryrun
from lct_gan_tpu_torch.parallel import mesh as mesh_mod
from lct_gan_tpu_torch.train import (TrainConfig, create_state,
                                     make_eval_step, validate)
from _torch_parallel_ranks import (VAL_CASES, fail_on_rank_one, val_ds,
                                   validate_cases)
from test_torch_port_train_step import _jax_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(segment_seconds=0.25, batch_size=4)
CFG, JCFG = TrainConfig(**KW), JaxTrainConfig(**KW)
METRICS = ("d_loss", "g_loss", "mr_loss", "mask_loss", "adv_loss", "fm_loss")
VAL_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _write_pair(root, split, uid, sec, sr, rng, channels=1, bits=16):
    T = int(sec * sr)
    t = np.arange(T) / sr
    clean = 0.2 * np.sin(2 * np.pi * (150 + 30 * len(uid)) * t)
    clean = np.stack([clean * (1 - 0.1 * c) for c in range(channels)])
    noisy = clean + 0.1 * rng.standard_normal(clean.shape)
    for sub, x in (("clean", clean), ("noisy", noisy)):
        write_wav(os.path.join(root, f"{sub}_{split}", f"{uid}.wav"),
                  x.astype(np.float32), sr, bits=bits)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 train utterances of 0.3-0.8 s; 6 test ones of 0.4-1.3 s (two
    length buckets), one of them a 48 kHz float file and one stereo."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for sub in ("clean", "noisy"):
            os.makedirs(os.path.join(root, f"{sub}_{split}"))
    train = [f"train{i:03d}" for i in range(8)]
    for i, uid in enumerate(train):
        _write_pair(root, "train", uid, 0.3 + 0.5 * i / 7, 16000, rng)
    test = []
    for i, (sec, sr, ch, bits) in enumerate(
            ((0.4, 16000, 1, 16), (1.3, 16000, 1, 16), (0.6, 48000, 1, 32),
             (0.8, 16000, 2, 16), (1.1, 16000, 1, 16), (0.5, 16000, 1, 16))):
        uid = f"test{i:03d}"
        _write_pair(root, "test", uid, sec, sr, rng, ch, bits)
        test.append(uid)
    for split, ids in (("train", train), ("test", test)):
        with open(os.path.join(root, f"{split}.scp"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


# ---- (a), (b): the sharded step ----

@pytest.fixture(scope="module")
def jax_state():
    return jax_create_state(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dp(jax_state):
    """3 steps over 2 ranks and over 1, all-f32, from the JAX state."""
    init = dryrun.StateInit(jax_params=(
        _np(jax_state.g_params), _np(jax_state.mpd_params),
        _np(jax_state.msd_params)), precise=True)
    return dryrun.dryrun(2, "cpu", cfg=CFG, init=init, steps=3,
                         capture=True)


def test_two_rank_step_matches_the_one_rank_step(dp):
    ranks, ref = dp["ranks"], dp["reference"]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["replicas_equal"] for r in ranks] == [[True] * 3] * 2
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    tol = dryrun.TOL["cpu"]
    assert tol == {"metric_rtol": 2e-4, "metric_atol": 1e-6,
                   "param_rtol": 1e-3, "param_atol": 2e-6}
    for got, want in zip(ranks[0]["metrics"], ref["metrics"]):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
    for k, want in ref["params_step1"].items():
        np.testing.assert_allclose(ranks[0]["params_step1"][k], want,
                                   rtol=1e-3, atol=2e-6, err_msg=k)
    assert ranks[0]["timing"][0]["reduce_ms"] > 0


@pytest.fixture(scope="module")
def jax_mesh_metrics(jax_state, dp):
    mesh = jax_make_mesh(devices=jax.devices()[:2])
    repl, bsh = jax_replicated(mesh), jax_batch_sharding(mesh)
    step = jax.jit(jax_make_train_step(JCFG), in_shardings=(repl, bsh, bsh),
                   out_shardings=(repl, repl))
    s, out = jax.device_put(jax_state, repl), []
    for noisy, clean in zip(dp["noisy"], dp["clean"]):
        s, m = step(s, jax.device_put(jnp.asarray(noisy), bsh),
                    jax.device_put(jnp.asarray(clean), bsh))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_two_rank_metrics_match_the_jax_two_device_mesh(dp,
                                                         jax_mesh_metrics):
    for got, want in zip(dp["ranks"][0]["metrics"], jax_mesh_metrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)


def test_two_rank_gradients_match_jax(dp, jax_state):
    """Step 1's gradients as the optimizers consumed them (after the
    all-reduce; G's after the clip too) against jax.grad of the global
    batch's D and G losses, clipped by optax's rule: within 1e-3 of each
    tensor's largest magnitude of the 1-rank port step's own distance from
    jax.grad. (On this batch that distance is already 6.5e-3 of the largest
    magnitude in the first conv of MPD's period-11 stack, weight_v and
    bias, whose gradients are sums with heavy cancellation; every other
    tensor is within 1e-3 outright, as the 1-rank test at B = 2 holds.)"""
    noisy, clean = (jnp.asarray(a[0]) for a in (dp["noisy"], dp["clean"]))
    jd, jg = _jax_grads(jax_state, noisy, clean)
    got = dp["ranks"][0]["grads_step1"]
    one = dp["reference"]["grads_step1"]
    # The state dict also holds buffers (the STFT windows): the norm is
    # over the parameters.
    want_g = {f"enhancer.{k}": v.numpy() for k, v in
              jax_params_to_state_dict(_np(jg)).items()
              if f"enhancer.{k}" in got["g"]}
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in want_g.values()))
    if norm >= CFG.grad_clip:
        want_g = {k: v / norm * CFG.grad_clip for k, v in want_g.items()}
    mpd_sd, msd_sd = jax_disc_params_to_state_dict(_np(jd["mpd"]),
                                                   _np(jd["msd"]))
    want_d = {**{f"mpd.{k}": v.numpy() for k, v in mpd_sd.items()},
              **{f"msd.{k}": v.numpy() for k, v in msd_sd.items()}}
    over = []
    for side, want in (("g", want_g), ("d", want_d)):
        assert set(got[side]) == set(one[side]) <= set(want)
        assert len(got[side]) > 10
        for name, g in got[side].items():
            ref = want[name]
            band = 1e-3 * np.abs(ref).max() + 1e-12
            one_err = float(np.abs(one[side][name] - ref).max())
            assert np.abs(g - ref).max() <= one_err + band, name
            if one_err > band:
                over.append(name)
    assert set(over) <= {"mpd.discriminators.4.convs.0.weight_v",
                         "mpd.discriminators.4.convs.0.bias"}, over


def test_clip_runs_after_the_reduce():
    """grad_clip 1e-3 always clips. The G gradients the 2-rank step applies
    equal the 1-rank step's clip of the global gradient; clipping each
    rank's gradient before the reduce gives a vector of another direction
    and length."""
    cfg = TrainConfig(**KW, grad_clip=1e-3)
    out = dryrun.dryrun(2, "cpu", cfg=cfg, steps=1, capture=True)
    got = out["ranks"][0]["grads_step1"]["g"]
    want = out["reference"]["grads_step1"]["g"]
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in want.values()))
    assert norm == pytest.approx(1e-3, rel=1e-4)   # the clip triggered
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


# ---- (c): sharded validation ----

def test_sharded_validate_matches_one_rank(tree):
    ranks = spawn(validate_cases, 2, "cpu", "gloo", tree)
    ref = validate_cases(make_mesh(1, "cpu"), tree)
    np.testing.assert_equal(ranks[0], ranks[1])   # the global result, on both
    for (case, _, _), got, want in zip(VAL_CASES, ranks[0], ref):
        for k in ("val_mrstft", "val_si_sdr", "val_stoi"):
            assert np.isfinite(want[k]), (case, k)
            np.testing.assert_allclose(got[k], want[k], **VAL_TOL,
                                       err_msg=f"{case} {k}")


# ---- (d): batch_iterator shards ----

class _CountingDataset(ScpDataset):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.decoded = []

    def __getitem__(self, index):
        self.decoded.append(int(index))
        return super().__getitem__(index)


def _datasets(tree, split):
    if split == "train":
        kw = dict(sample_rate=16000, segment_length=CFG.segment_length,
                  random_segment=True, seed=7)
    else:
        kw = dict(sample_rate=16000, segment_length=None,
                  random_segment=False)
    return lambda: _CountingDataset(tree, f"{split}.scp", split, **kw)


SHARD_CASES = {
    "train": ("train", dict(batch_size=4, shuffle=True, drop_last=True,
                            pad_to_segment=True, seed=7, epoch=3)),
    "adaptive_val": ("test", dict(batch_size=8, bucket=True,
                                  sort_by_length=True,
                                  adaptive_target_samples=40000)),
    "fixed_val": ("test", dict(batch_size=4, bucket=True,
                               sort_by_length=True)),
}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shards_put_together_are_the_global_batches(tree, case, world):
    split, kw = SHARD_CASES[case]
    make = _datasets(tree, split)
    whole = list(batch_iterator(make(), num_workers=0, **kw))
    shards = []
    for r in range(world):
        ds = make()
        shards.append((list(batch_iterator(ds, num_workers=2,
                                           shard=(r, world), **kw)),
                       ds.decoded))
    assert all(len(s) == len(whole) for s, _ in shards)
    for g, batch in enumerate(whole):
        parts = [s[g] for s, _ in shards]
        for p in parts:
            assert p["global_rows"] == batch["noisy"].shape[0]
            assert p["noisy"].shape[1] == batch["noisy"].shape[1]
            assert not p["lengths"][p["valid"]:].any()   # padding rows
        for k in ("noisy", "clean", "lengths"):
            joined = np.concatenate([p[k][:p["valid"]] for p in parts])
            assert joined.dtype == batch[k].dtype
            assert np.array_equal(joined, batch[k]), (g, k)
        assert sum((p["id"][:p["valid"]] for p in parts), []) == batch["id"]
    # Each rank decoded its own rows only: as many decodes as rows it holds.
    for s, decoded in shards:
        assert len(decoded) == sum(p["noisy"].shape[0] for p in s)
    if case == "train" and 4 % world == 0:
        assert sum(len(d) for _, d in shards) == sum(
            b["noisy"].shape[0] for b in whole)


# ---- (g): the train CLI ----

@pytest.mark.parametrize("launch", ["spawn", "torchrun"])
def test_train_cli_data_parallel_two_ranks(tree, tmp_path, launch):
    """Two ranks started by the CLI itself, or by torchrun (each rank runs
    the CLI and joins through RANK / WORLD_SIZE)."""
    expr = tmp_path / "exprs"
    args = ["--data_root", tree, "--expr_root", str(expr), "--epochs", "1",
            "--segment_seconds", "0.25", "--batch_size", "4",
            "--val_interval", "1", "--ckpt_interval", "1",
            "--log_interval", "1", "--no_pesq", "--no_stoi",
            "--num_workers", "0", "--data_parallel", "2", "--device", "cpu"]
    if launch == "spawn":
        out = train_cli.main(args)
        assert out["epochs"][0]["steps"] == 2   # 8 utterances, global B = 4
    else:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "lct_gan_tpu_torch.train_cli",
             *args], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "Data parallel: 2 ranks, backend gloo" in proc.stdout
        assert proc.stdout.count("Training finished.") == 1   # rank 0 logs
    runs = os.listdir(expr)
    assert len(runs) == 1
    run = expr / runs[0]
    if launch == "spawn":
        assert out["run_dir"] == str(run)
    assert sorted(os.listdir(run / "ckpts")) == [
        "best.pt", "epoch_0001.pt", "last.pt"]
    with open(run / "configs.json") as f:
        configs = json.load(f)
    assert (configs["devices"], configs["backend"]) == (2, "gloo")
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and int(rows[0]["epoch"]) == 1
    enhancer = load_enhancer(str(run / "ckpts" / "best.pt"), device="cpu")
    want = validate(make_eval_step(CFG), enhancer, val_ds(tree), CFG, 4,
                    compute_pesq=False, compute_stoi=False, num_workers=0,
                    adaptive_target_seconds=256.0)
    for k in ("val_mrstft", "val_si_sdr"):
        np.testing.assert_allclose(float(rows[0][k]), want[k], **VAL_TOL,
                                   err_msg=k)


# ---- the mesh's own rules ----

def test_world_one_mesh_is_the_identity():
    mesh = make_mesh(1, "cpu")
    assert (mesh.rank, mesh.world, mesh.backend, mesh.group) == (
        0, 1, None, None)
    assert make_mesh(device="cpu").world == 1     # the CPU's default
    state = create_state(CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    before = [t.clone() for t in mesh_mod.state_tensors(state)]
    assert broadcast_state_(state, mesh) is state
    assert replicas_equal(state, mesh)
    grads = [torch.ones(3), torch.full((2, 2), 4.0)]
    assert all_reduce_mean_(grads, mesh) is grads
    assert torch.equal(grads[1], torch.full((2, 2), 4.0))
    batch = {"noisy": np.zeros((3, 5))}
    assert shard_batch(batch, mesh) is batch
    assert all(torch.equal(a, b) for a, b in
               zip(before, mesh_mod.state_tensors(state)))


@pytest.mark.parametrize("device, cards, world, want", [
    ("cpu", 0, 2, ("gloo", ["cpu", "cpu"])),
    ("cuda", 2, 2, ("nccl", ["cuda:0", "cuda:1"])),
    ("cuda", 4, 2, ("nccl", ["cuda:0", "cuda:1"])),
    ("cuda", 1, 2, ("gloo", ["cuda:0", "cuda:0"])),
    ("cuda", 2, 4, ("gloo", ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])),
    ("cuda:1", 2, 2, ("gloo", ["cuda:1", "cuda:1"])),
])
def test_backend_rule(monkeypatch, device, cards, world, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = [mesh_mod._backend_and_device(world, torch.device(device), r)
           for r in range(world)]
    assert {b for b, _ in got} == {want[0]}
    assert [str(d) for _, d in got] == want[1]


def test_make_mesh_refuses_a_backend_the_rule_does_not_pick():
    with pytest.raises(ValueError, match="backend 'nccl' asked for"):
        make_mesh(2, "cpu", rank=0, init_method="file:///nonexistent",
                  backend="nccl")


def test_shard_batch_gives_each_rank_its_rows():
    batch = {"noisy": np.arange(12).reshape(6, 2), "lengths": np.arange(6),
             "id": list("abcdef")}
    rows = [shard_batch(batch, Mesh(r, 3, torch.device("cpu"), "gloo"))
            for r in range(3)]
    assert np.array_equal(np.concatenate([r["noisy"] for r in rows]),
                          batch["noisy"])
    assert [r["lengths"].tolist() for r in rows] == [[0, 1], [2, 3], [4, 5]]
    assert rows[1]["id"] == batch["id"]      # only the array keys split
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"noisy": np.zeros((5, 2))},
                    Mesh(0, 2, torch.device("cpu"), "gloo"))


def test_spawn_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                                           "rank one refuses"):
        spawn(fail_on_rank_one, 2, "cpu")

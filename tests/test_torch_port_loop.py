"""The port's training run (lct_gan_tpu_torch/train/loop.py, checkpoint.py,
train_cli.py) on the CPU, on a seeded synthetic tree (8 train utterances of
0.3-0.8 s, 5 test ones of 0.4-0.8 s; segment 0.25 s, B = 4):

  * against the JAX package, on the weights of one JAX `create_state`:
    `validate` (val_mrstft rtol 1e-4, val_si_sdr atol 1e-3, val_stoi atol
    1e-4, the tolerances of test_eval_step_matches_jax); a port checkpoint
    read by the JAX package's `state_from_torch_checkpoint` (every
    generator, MPD and MSD parameter equal, atol 0); the port's generator
    `.npz` read by the JAX `load_generator_params` (equal) and by the port
    (bit-equal, meta kept);
  * the port alone, as tests/test_train_loop.py checks the JAX loop:
    the run directory's files, a run resumed through the train CLI from
    epoch 1's checkpoint bit-equal to the uninterrupted run, overlapped
    scoring bit-equal to serial scoring, validation invariant to tail-batch
    padding, the CLI's flags and its refusal of data parallelism. (The
    `profile_steps` trace starts at step 3, past these runs' 2 steps an
    epoch; chip_smoke.py's loop phase checks it on the card.)
"""

import csv
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
from lct_gan_tpu.data import ScpDataset as JaxScpDataset
from lct_gan_tpu.train import checkpoint as jax_checkpoint
from lct_gan_tpu.train.loop import validate as jax_validate
from lct_gan_tpu.train.state import TrainConfig as JaxTrainConfig
from lct_gan_tpu.train.state import create_state as jax_create_state
from lct_gan_tpu.train.step import make_eval_step as jax_make_eval_step
from lct_gan_tpu_torch import train_cli
from lct_gan_tpu_torch.convert import (jax_disc_params_to_state_dict,
                                       jax_params_to_state_dict,
                                       load_enhancer, read_npz_params,
                                       save_generator_params_npz,
                                       state_dict_to_jax_params)
from lct_gan_tpu_torch.data import ScpDataset, write_wav
from lct_gan_tpu_torch.train import (DataConfig, TrainConfig,
                                     latest_checkpoint, make_eval_step,
                                     read_checkpoint_meta,
                                     restore_checkpoint, run_training,
                                     save_checkpoint, state_from_jax_params,
                                     validate)
from lct_gan_tpu_torch.utils import to_jsonable

SEG = dict(segment_seconds=0.25, batch_size=4)
CFG = TrainConfig(**SEG, epochs=2, val_interval=1, ckpt_interval=1,
                  log_interval=1)
JCFG = JaxTrainConfig(**SEG)
QUIET = dict(device="cpu", compute_pesq=False, compute_stoi=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_tree(root, n_train=8, n_test=5, sr=16000):
    rng = np.random.default_rng(0)
    for split, n, lo in (("train", n_train, 0.3), ("test", n_test, 0.4)):
        for sub in ("clean", "noisy"):
            os.makedirs(os.path.join(root, f"{sub}_{split}"), exist_ok=True)
        ids = []
        for i in range(n):
            uid = f"{split}{i:03d}"
            T = int(sr * (lo + (0.8 - lo) * i / (n - 1)))
            t = np.arange(T) / sr
            clean = (0.2 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                     + 0.05 * rng.standard_normal(T)).astype(np.float32)
            noisy = clean + (0.1 * rng.standard_normal(T)).astype(np.float32)
            write_wav(os.path.join(root, f"clean_{split}", f"{uid}.wav"),
                      clean, sr)
            write_wav(os.path.join(root, f"noisy_{split}", f"{uid}.wav"),
                      noisy, sr)
            ids.append(uid)
        with open(os.path.join(root, f"{split}.scp"), "w") as f:
            f.write("\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    _make_tree(root)
    return root


@pytest.fixture(scope="module")
def full_run(tree, tmp_path_factory):
    """The uninterrupted 2-epoch run; its last.pt as loaded right after."""
    out = run_training(CFG, DataConfig(data_root=tree, num_workers=2),
                       expr_root=str(tmp_path_factory.mktemp("exprs")),
                       **QUIET)
    last = os.path.join(out["run_dir"], "ckpts", "last.pt")
    return out, torch.load(last, weights_only=True)


@pytest.fixture(scope="module")
def jax_state():
    return jax_create_state(JCFG, jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def port_state(jax_state):
    return state_from_jax_params(
        CFG, _np(jax_state.g_params), _np(jax_state.mpd_params),
        _np(jax_state.msd_params), device="cpu", precise=True)


def _val_ds(cls, tree):
    return cls(tree, "test.scp", "test", sample_rate=16000,
               segment_length=None, random_segment=False)


def _same(a, b):
    """Two checkpoint payload entries equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b or (a != a and b != b)


def test_run_training_writes_the_run_directory(full_run):
    out, last = full_run
    run_dir = out["run_dir"]
    ckpts = os.path.join(run_dir, "ckpts")
    assert sorted(os.listdir(ckpts)) == [
        "best.pt", "epoch_0001.pt", "epoch_0002.pt", "last.pt"]
    assert latest_checkpoint(ckpts) == os.path.join(ckpts, "last.pt")
    with open(os.path.join(run_dir, "configs.json")) as f:
        assert json.load(f)["train_cfg"]["batch_size"] == 4
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [1, 2]
    assert np.isfinite(out["best_val"]) and out["best_epoch"] in (1, 2)
    assert [e["steps"] for e in out["epochs"]] == [2, 2]
    assert all(len(e["step_ms"]) == 2 for e in out["epochs"])
    # The reference's payload keys, plain types only (weights_only).
    assert set(last) == {"epoch", "best_val", "best_epoch", "enhancer",
                         "mpd", "msd", "g_opt", "d_opt", "step",
                         "val_metrics", "args"}
    assert last["epoch"] == 2 and last["step"] == 4
    assert last["args"]["compress_c"] == CFG.compress_c
    meta = read_checkpoint_meta(os.path.join(ckpts, "best.pt"))
    assert meta["epoch"] == out["best_epoch"]
    assert meta["train_cfg"]["max_time_context"] is None
    enhancer = load_enhancer(os.path.join(ckpts, "best.pt"), device="cpu")
    best = torch.load(os.path.join(ckpts, "best.pt"), weights_only=True)
    for k, v in enhancer.state_dict().items():
        assert torch.equal(v, best["enhancer"][k]), k


@pytest.fixture(scope="module")
def cli_resumed(full_run, tree, tmp_path_factory):
    """Epoch 1's checkpoint (a copy of the uninterrupted run's
    epoch_0001.pt, which is its epoch-1 last.pt) resumed to epoch 2 through
    the train CLI on the CPU: one epoch, in the copy's run directory."""
    root = tmp_path_factory.mktemp("resume")
    ckpts = root / "run" / "ckpts"
    ckpts.mkdir(parents=True)
    shutil.copy(os.path.join(full_run[0]["run_dir"], "ckpts",
                             "epoch_0001.pt"), ckpts / "last.pt")
    out = train_cli.main([
        "--data_root", tree, "--resume", str(ckpts / "last.pt"),
        "--epochs", "2", "--segment_seconds", "0.25", "--batch_size", "4",
        "--val_interval", "1", "--ckpt_interval", "1", "--log_interval",
        "1", "--no_pesq", "--no_stoi", "--num_workers", "0", "--device",
        "cpu"])
    return out, str(root / "run")


def test_resumed_run_equals_the_uninterrupted_run(full_run, cli_resumed):
    """All three models (spectral buffers included), both optimizers and
    the counters bit-equal to the uninterrupted 2-epoch run's last.pt."""
    out, run_dir = cli_resumed
    assert out["run_dir"] == run_dir
    got = torch.load(os.path.join(run_dir, "ckpts", "last.pt"),
                     weights_only=True)
    want = full_run[1]
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k


def test_train_cli_runs_one_epoch_on_cpu(cli_resumed):
    out, run_dir = cli_resumed
    assert [e["epoch"] for e in out["epochs"]] == [2]
    assert out["epochs"][0]["steps"] == 2
    best = ["best.pt"] if out["best_epoch"] == 2 else []
    assert sorted(os.listdir(os.path.join(run_dir, "ckpts"))) == sorted(
        ["epoch_0002.pt", "last.pt"] + best)
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [2]
    assert np.isnan(float(rows[0]["val_pesq"]))
    meta = read_checkpoint_meta(os.path.join(run_dir, "ckpts", "last.pt"))
    assert meta["epoch"] == 2 and meta["train_cfg"]["epochs"] == 2


def test_checkpoint_round_trip_and_optimizer_device(full_run, tmp_path):
    _, last = full_run
    state, meta = restore_checkpoint(
        os.path.join(full_run[0]["run_dir"], "ckpts", "last.pt"), CFG,
        device="cpu")
    assert meta["epoch"] == 2 and state.step == 4
    for p in state.g_params() + state.d_params():
        st = state.g_opt.state.get(p) or state.d_opt.state[p]
        assert st["exp_avg"].device == p.device
    path = save_checkpoint(str(tmp_path), "again", state,
                           {**meta, "train_cfg": CFG})
    again = torch.load(path, weights_only=True)
    for k in ("enhancer", "mpd", "msd", "g_opt", "d_opt", "step", "epoch"):
        assert _same(again[k], last[k]), k
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_jax_package_reads_the_port_checkpoint(full_run, jax_state,
                                               monkeypatch):
    """The JAX package's `state_from_torch_checkpoint` (torch.load in
    process: LCT_TORCH_INPROC=1, tests/conftest.py) takes the port's
    `.pt` as the reference format: its generator, MPD and MSD params equal
    the port's through the weight bridge, atol 0."""
    best = os.path.join(full_run[0]["run_dir"], "ckpts", "best.pt")
    # It builds its template with create_state(JCFG, PRNGKey(0)): the
    # module fixture's value, computed once.
    monkeypatch.setattr(jax_checkpoint, "create_state",
                        lambda cfg, rng: jax_state)
    js = jax_checkpoint.state_from_torch_checkpoint(best, JCFG)
    port = torch.load(best, weights_only=True)
    want_g = jax_params_to_state_dict(_np(js.g_params))
    want_mpd, want_msd = jax_disc_params_to_state_dict(
        _np(js.mpd_params), _np(js.msd_params))
    for want, got in ((want_g, port["enhancer"]), (want_mpd, port["mpd"]),
                      (want_msd, port["msd"])):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(want[k].numpy(), got[k].numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("source", ["enhancer", "state_dict"])
def test_generator_npz_moves_weights_both_ways(jax_state, tmp_path, source):
    sd = jax_params_to_state_dict(_np(jax_state.g_params))
    cfg = dataclasses.replace(CFG, max_time_context=64, compress_c=0.25)
    meta = json.loads(json.dumps({"epoch": 7,
                                  "train_cfg": to_jsonable(cfg)}))
    arg = sd
    if source == "enhancer":
        arg = load_enhancer(save_generator_params_npz(
            str(tmp_path / "seed.npz"), sd), device="cpu")
    path = save_generator_params_npz(str(tmp_path / "g.npz"), arg, meta)
    # The JAX package reads it as its own serving weights.
    got = jax_checkpoint.load_generator_params(path, JCFG)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(jax_state.g_params))
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want[0])
    for key, v in flat_want[0]:
        assert flat_got[key].dtype == v.dtype
        np.testing.assert_array_equal(flat_got[key], v, err_msg=str(key))
    assert jax_checkpoint.read_checkpoint_meta(path) == meta
    # Port -> npz -> port is bit-equal; the meta survives and is honoured.
    params, got_meta = read_npz_params(path)
    assert got_meta == meta
    back = jax_params_to_state_dict(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    enhancer = load_enhancer(path, device="cpu")
    assert enhancer.c == 0.25
    assert enhancer.gen.cfg.max_time_context == 64
    rt = state_dict_to_jax_params(enhancer.state_dict())
    assert rt["gen"].keys() == params["gen"].keys()


def test_validate_matches_jax(jax_state, port_state, tree):
    kw = dict(compute_pesq=False, compute_stoi=True, num_workers=2,
              adaptive_target_seconds=CFG.val_target_batch_seconds)
    want = jax_validate(jax.jit(jax_make_eval_step(JCFG)), jax_state.g_params,
                        _val_ds(JaxScpDataset, tree), JCFG, 4, **kw)
    got = validate(make_eval_step(CFG), port_state.enhancer,
                   _val_ds(ScpDataset, tree), CFG, 4, **kw)
    np.testing.assert_allclose(got["val_mrstft"], want["val_mrstft"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_si_sdr"], want["val_si_sdr"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["val_stoi"], want["val_stoi"], rtol=0,
                               atol=1e-4)
    assert np.isnan(got["val_pesq"]) and np.isnan(want["val_pesq"])


def test_validate_overlapped_scoring_is_bit_identical(port_state, tree):
    ds = _val_ds(ScpDataset, tree)
    step = make_eval_step(CFG)
    par = validate(step, port_state.enhancer, ds, CFG, 4,
                   compute_pesq=False, compute_stoi=True, num_workers=4)
    ser = validate(step, port_state.enhancer, ds, CFG, 4,
                   compute_pesq=False, compute_stoi=True, num_workers=1)
    assert np.isfinite(par["val_stoi"])
    for k in par:
        assert par[k] == ser[k] or (np.isnan(par[k]) and np.isnan(ser[k])), k


def test_validation_invariant_to_tail_batch_padding(port_state, tree):
    """5 utterances: batches of 5 (exact), 8 (3 padded rows) and 3 (a tail
    of 2 padded to 3) give the same means."""
    ds = _val_ds(ScpDataset, tree)
    step = make_eval_step(CFG)
    runs = [validate(step, port_state.enhancer, ds, CFG, bs,
                     compute_pesq=False, compute_stoi=False)
            for bs in (5, 8, 3)]
    for r in runs[1:]:
        for k in ("val_mrstft", "val_si_sdr"):
            np.testing.assert_allclose(r[k], runs[0][k], rtol=1e-5)


@pytest.mark.parametrize("n", ["2", "8"])
def test_train_cli_refuses_data_parallel(tree, tmp_path, n):
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        train_cli.main(["--data_root", tree, "--expr_root", str(tmp_path),
                        "--data_parallel", n, "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_train_cli_flags_match_the_jax_cli(monkeypatch):
    """Every flag of the JAX package's train.py, with its default, plus
    --device."""
    import train as jax_train_cli

    monkeypatch.setattr("sys.argv", ["train.py", "--data_root", "D"])
    want = vars(jax_train_cli.parse_args())
    got = vars(train_cli.parse_args(["--data_root", "D"]))
    assert got.pop("device") == "cuda"
    assert got == want

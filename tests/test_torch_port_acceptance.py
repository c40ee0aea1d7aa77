"""The port's acceptance driver (lct_gan_tpu_torch/acceptance.py) against
`tools/acceptance.py` on the CPU:

  * its synthetic tree is byte-equal to the JAX driver's, scp files too;
  * stage 2 (ScpDataset + batch_iterator + compute_tf_features) gives the
    JAX driver's stage-2 batch, its noisy_mag_c within the TF-feature
    tests' rtol 1e-4 and its irm_c within the STFT tests' spectrum
    tolerance carried through the compressed mask;
  * the verdict: all PASS -> rc 0, one FAIL -> rc 1, SKIPs alone -> rc 0,
    with the exact JSON last line;
  * failing CLIs fail their stages and the run's exit code;
  * the parity gate's reference code comes only from an explicit
    $LCT_REFERENCE_ROOT, which has no default;
  * one whole `--synthetic --device cpu` run at the driver's defaults:
    rc 0, stages 2/3/4/1/5 PASS and the parity gate G SKIP.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lct_gan_tpu.data import ScpDataset as JaxScpDataset
from lct_gan_tpu.data import batch_iterator as jax_batch_iterator
from lct_gan_tpu.sigproc import TFFeaturesConfig as JTFConfig
from lct_gan_tpu.sigproc import compute_tf_features as jax_tf_features
from lct_gan_tpu_torch import acceptance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "_jax_acceptance", os.path.join(ROOT, "tools", "acceptance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    ours = str(tmp_path_factory.mktemp("port_tree"))
    theirs = str(tmp_path_factory.mktemp("jax_tree"))
    acceptance.make_synthetic_tree(ours, SR)
    _jax_driver().make_synthetic_tree(theirs, SR)
    return ours, theirs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_synthetic_tree_is_byte_equal_to_the_jax_drivers(trees):
    ours, theirs = trees
    files = _files(ours)
    assert files == _files(theirs)
    assert len(files) == 2 * (16 + 4) + 2
    assert {"train.scp", "test.scp"} <= set(files)
    for rel in files:
        with open(os.path.join(ours, rel), "rb") as a, \
                open(os.path.join(theirs, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_stage_2_matches_the_jax_drivers(trees):
    root = trees[0]
    batch, feats = acceptance.stage_features(root, 0.25, SR, 8)
    # tools/acceptance.py's stage 2, on the same tree.
    ds = JaxScpDataset(root, "train.scp", "train", sample_rate=SR,
                       segment_length=int(0.25 * SR), random_segment=True,
                       seed=42)
    jbatch = next(iter(jax_batch_iterator(ds, 8, pad_to_segment=True)))
    jfeats = jax_tf_features(
        jnp.asarray(jbatch["noisy"]), jnp.asarray(jbatch["clean"]),
        JTFConfig(n_fft=512, compress_input=False, return_stfts=True))
    assert batch["noisy"].shape == jbatch["noisy"].shape == (8, 4000)
    assert np.array_equal(batch["noisy"], jbatch["noisy"])
    assert np.array_equal(batch["clean"], jbatch["clean"])
    assert set(feats) == {"noisy_mag", "irm_c", "noisy_mag_c"}
    for k in feats:
        assert tuple(feats[k].shape) == jfeats[k].shape == (8, 257, 16)
    np.testing.assert_allclose(feats["noisy_mag_c"].numpy(),
                               np.asarray(jfeats["noisy_mag_c"]), rtol=1e-4)
    # The clean side is a pure tone: most of its bins hold only the FFT's
    # rounding (|S| ~ 1e-6 against a peak of ~38), where |S|^0.3 magnifies
    # the two FFTs' last-ulp difference (found 1.5e-3 at irm_c ~ 0.11).
    # The bins below 1e-3 x the largest (about 90% here: window leakage and
    # rounding) are held to the STFT tests' spectrum tolerance (atol 1e-5 x
    # the largest bin) carried through irm_c = |S|^c / |X|^c; the tone's
    # bins to the feature tests' rtol 1e-4 alone.
    c = 0.3
    S = np.abs(np.asarray(jfeats["clean_stft"]))
    X = np.abs(np.asarray(jfeats["noisy_stft"]))
    want = np.asarray(jfeats["irm_c"])
    got = feats["irm_c"].numpy()
    rounding = S < 1e-3 * S.max()
    assert 0 < rounding.mean() < 1
    tol = ((S + 1e-5 * S.max()) ** c - S ** c) / X ** c + 1e-4 * np.abs(want)
    assert np.all(np.abs(got - want)[rounding] <= tol[rounding])
    np.testing.assert_allclose(got[~rounding], want[~rounding], rtol=1e-4)


def _stages(statuses):
    out = []
    for config, status in zip("23415G", statuses):
        st = acceptance.Stage(config, f"stage {config}")
        {"PASS": st.ok, "FAIL": st.fail, "SKIP": st.skip}[status]("d")
        out.append(st)
    return out


@pytest.mark.parametrize("statuses, rc, verdict", [
    (["PASS"] * 6, 0, "PASS"),
    (["PASS", "PASS", "FAIL", "PASS", "PASS", "SKIP"], 1, "FAIL"),
    (["SKIP"] * 6, 0, "PASS"),
])
def test_report_verdict_and_json_line(statuses, rc, verdict):
    out = io.StringIO()
    assert acceptance.report(_stages(statuses), 12.0, out) == rc
    lines = out.getvalue().splitlines()
    assert lines[-2] == f"VERDICT: {verdict}"
    assert lines[-1] == json.dumps(
        {"verdict": verdict, "stages": dict(zip("23415G", statuses))})


def test_failing_clis_fail_their_stages(tmp_path, monkeypatch, capsys):
    ran = []

    def failing_cli(module, args, log_path, timeout=7200):
        ran.append(module.rsplit(".", 1)[-1])
        with open(log_path, "w") as f:
            f.write("boom\n")
        return 1

    monkeypatch.setattr(acceptance, "_run_cli", failing_cli)
    monkeypatch.setattr(acceptance, "REFERENCE_ROOT",
                        str(tmp_path / "no-reference"))
    rc = acceptance.run(acceptance.parse_args(
        ["--synthetic", "--device", "cpu", "--work_dir", str(tmp_path)]))
    assert rc == 1
    assert ran == ["train_cli", "train_cli", "entry"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "verdict": "FAIL",
        "stages": {"2": "PASS", "3": "FAIL", "4": "FAIL", "1": "SKIP",
                   "5": "FAIL", "G": "SKIP"}}


def test_the_parity_gate_reads_only_an_explicit_reference_root(tmp_path,
                                                             monkeypatch):
    env = dict(os.environ)
    env.pop("LCT_REFERENCE_ROOT", None)
    proc = subprocess.run(
        [sys.executable, "-c", "from lct_gan_tpu_torch import acceptance; "
         "print(acceptance.REFERENCE_ROOT)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.stdout.splitlines()[-1] == "None", proc.stderr[-2000:]

    ran = []
    monkeypatch.setattr(acceptance, "_run_cli",
                        lambda *a, **k: ran.append(a) or 0)
    monkeypatch.setattr(acceptance, "REFERENCE_ROOT", None)
    st = acceptance.parity_gate(
        acceptance.Stage("G", "gate"), str(tmp_path), "test.scp",
        str(tmp_path / "ref.pt"), str(tmp_path), SR, "cpu", io.StringIO())
    assert st.status == "FAIL" and "LCT_REFERENCE_ROOT" in st.detail
    assert ran == []


def test_synthetic_run_passes_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env.pop("OMP_NUM_THREADS", None)
    env["LCT_REFERENCE_ROOT"] = str(tmp_path / "no-reference")
    proc = subprocess.run(
        [sys.executable, "-m", "lct_gan_tpu_torch.acceptance", "--synthetic",
         "--device", "cpu", "--work_dir", str(tmp_path / "work")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-2] == "VERDICT: PASS"
    assert json.loads(lines[-1]) == {
        "verdict": "PASS",
        "stages": {"2": "PASS", "3": "PASS", "4": "PASS", "1": "PASS",
                   "5": "PASS", "G": "SKIP"}}
    work = tmp_path / "work"
    for gan_loss in ("ls", "hinge"):
        (run,) = os.listdir(work / f"expr_{gan_loss}")
        assert (work / f"expr_{gan_loss}" / run / "ckpts" / "best.pt"
                ).is_file()
    for out in ("enhanced_test", "enhanced_stream"):
        assert sorted(os.listdir(work / out)) == [
            f"test{i:03d}.wav" for i in range(4)]

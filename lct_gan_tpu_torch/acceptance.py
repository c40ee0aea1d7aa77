"""One-command acceptance driver for the port (the counterpart of
`tools/acceptance.py`).

    python -m lct_gan_tpu_torch.acceptance --synthetic [--device cpu]
    python -m lct_gan_tpu_torch.acceptance --data_root D [--reference_pt P]

Runs the port's own CLIs in subprocesses, as a user would, against
--data_root (or a synthetic tree it writes), and prints a verdict table:

  2. feature pipeline on segment batches   (ScpDataset + batch_iterator,
                                            compute_tf_features)
  3. `train_cli --gan_loss ls`             (best.pt and metrics.csv)
  4. `train_cli --gan_loss hinge` + val
  1. `infer` over the test split, then `metrics_cli`
  5. `entry 2` (the 2-rank data-parallel dry run) + chunked streaming infer
  G. parity gate against the PyTorch reference: the port serving a
     reference checkpoint against the reference's own code run as an
     oracle (torch-only child), scored against clean: PESQ-wb within 0.01
     when the `pesq` wheel is importable, else SI-SDR within 0.1 dB, STOI
     within 0.001 and fwSegSNR within 0.1 dB. The oracle is the reference's
     code at $LCT_REFERENCE_ROOT, which has no default. Runs with
     --reference_pt (FAIL when that variable is unset), or with --synthetic
     where the variable names a directory; SKIP otherwise.

--device (default cuda) goes to every CLI that takes one (train_cli,
infer, entry); metrics_cli runs on the host. The children get one torch
thread (OMP_NUM_THREADS=1) unless the caller set OMP_NUM_THREADS. The last
line is {"verdict": "PASS"|"FAIL", "stages": {...}}; exit code 0 if and
only if no stage FAILed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, TextIO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_ROOT = os.environ.get("LCT_REFERENCE_ROOT") or None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The port's acceptance driver")
    p.add_argument("--data_root", type=str, default=None,
                   help="Dataset tree (train_cli layout). Omit with "
                        "--synthetic to write one.")
    p.add_argument("--synthetic", action="store_true",
                   help="Write a synthetic dataset (and, where the "
                        "reference code is found and --reference_pt is not "
                        "given, a reference .pt) so the driver runs with no "
                        "external data.")
    p.add_argument("--reference_pt", type=str, default=None,
                   help="Reference PyTorch checkpoint ({'enhancer': "
                        "state_dict, 'args': {...}}) for the parity gate.")
    p.add_argument("--work_dir", type=str, default=None,
                   help="Where runs and outputs land (default: temp dir).")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--segment_seconds", type=float, default=None,
                   help="Default: 2.0 (reference), 0.25 under --synthetic.")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--skip_train", action="store_true",
                   help="Skip stages 3-4 (use with --checkpoint).")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Checkpoint for stages 1 and 5 when --skip_train "
                        "(otherwise stage 3's best.pt).")
    p.add_argument("--keep_work_dir", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, for every CLI run")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# plumbing

class Stage:
    """One stage's status and detail, and its wall seconds from creation
    to the verdict."""

    def __init__(self, config: str, desc: str):
        self.config = config
        self.desc = desc
        self.status = "SKIP"
        self.detail = ""
        self.seconds = 0.0
        self._t0 = time.perf_counter()

    def _end(self, status, detail):
        self.status, self.detail = status, detail
        self.seconds = time.perf_counter() - self._t0
        return self

    def ok(self, detail=""):
        return self._end("PASS", detail)

    def fail(self, detail=""):
        return self._end("FAIL", detail)

    def skip(self, detail=""):
        return self._end("SKIP", detail)


def child_env(pythonpath: bool = True) -> dict:
    """The children's environment: one torch thread unless the caller set
    OMP_NUM_THREADS (on a shared CPU a train step at 8 threads can take 30x
    the one-thread time), and the repository on PYTHONPATH."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    if pythonpath:
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    else:
        env.pop("PYTHONPATH", None)
    return env


def _run_cli(module: str, args: Sequence[str], log_path: str,
             timeout=7200) -> int:
    """`python -m module args` as the user would run it, output to
    log_path; its exit code (124 when it ran past `timeout` seconds)."""
    with open(log_path, "w") as log:
        try:
            proc = subprocess.run([sys.executable, "-m", module, *args],
                                  cwd=REPO, env=child_env(), stdout=log,
                                  stderr=subprocess.STDOUT, timeout=timeout)
        except subprocess.TimeoutExpired:
            print(f"timed out after {timeout} s", file=log)
            return 124
    return proc.returncode


def _tail(path, n=5):
    try:
        with open(path) as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def _test_ids(scp_path: str) -> List[str]:
    with open(scp_path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


# ---------------------------------------------------------------------------
# synthetic fixtures

def make_synthetic_tree(root: str, sr: int, n_train=16, n_test=4,
                        seconds=0.4):
    """D/{clean,noisy}_{train,test}/<id>.wav and D/{train,test}.scp:
    tone + noise pairs, 0.4 s plus 10 ms per index, from one seeded rng."""
    import numpy as np

    from lct_gan_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("test", n_test)):
        cdir = os.path.join(root, f"clean_{split}")
        ndir = os.path.join(root, f"noisy_{split}")
        os.makedirs(cdir, exist_ok=True)
        os.makedirs(ndir, exist_ok=True)
        ids = []
        for i in range(n):
            uid = f"{split}{i:03d}"
            ids.append(uid)
            T = int(sr * seconds) + i * 160
            t = np.arange(T) / sr
            f0 = float(rng.uniform(150, 1500))
            clean = (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
            noisy = clean + (rng.standard_normal(T) * 0.1).astype(np.float32)
            write_wav(os.path.join(cdir, f"{uid}.wav"), clean, sr)
            write_wav(os.path.join(ndir, f"{uid}.wav"), noisy, sr)
        with open(os.path.join(root, f"{split}.scp"), "w") as f:
            f.write("\n".join(ids) + "\n")


# The reference's own code, torch only (its torchaudio import stubbed):
# a freshly initialised enhancer's checkpoint, seeded.
_MAKE_REF_PT = r"""
import sys, types, importlib, torch
ref_root, out_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, ref_root)
for mod in list(sys.modules):
    if mod == "datasets" or mod.startswith("datasets."):
        del sys.modules[mod]
if "torchaudio" not in sys.modules:
    ta = types.ModuleType("torchaudio")
    ta.functional = types.ModuleType("torchaudio.functional")
    sys.modules["torchaudio"] = ta
    sys.modules["torchaudio.functional"] = ta.functional
gen = importlib.import_module("models.generator")
torch.manual_seed(0)
enh = gen.LCTEnhancer(gen_cfg=gen.LCTGeneratorConfig(), c=0.3)
torch.save({"enhancer": enh.state_dict(),
            "args": {"compress_c": 0.3}}, out_path)
print("wrote", out_path)
"""

# The oracle: the reference enhancer over the test split, one utterance at
# a time at its exact length, reading and writing waves through the port's
# data/audio_io.py (the repository goes after the reference's root on
# sys.path, so the reference's own `models` is the one imported).
_REF_INFER = r"""
import os, sys, types, importlib
import numpy as np, torch
(ref_root, repo, ckpt_path, data_root, scp_path, out_dir,
 sr) = sys.argv[1:8]
sr = int(sr)
sys.path.insert(0, ref_root)
sys.path.append(repo)
for mod in list(sys.modules):
    if mod == "datasets" or mod.startswith("datasets."):
        del sys.modules[mod]
if "torchaudio" not in sys.modules:
    ta = types.ModuleType("torchaudio")
    ta.functional = types.ModuleType("torchaudio.functional")
    sys.modules["torchaudio"] = ta
    sys.modules["torchaudio.functional"] = ta.functional
from lct_gan_tpu_torch.data import audio_io
gen_mod = importlib.import_module("models.generator")

ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
args = ckpt.get("args", {})
cfg = gen_mod.LCTGeneratorConfig(
    max_time_context=args.get("max_time_context", 200))
enh = gen_mod.LCTEnhancer(gen_cfg=cfg, c=args.get("compress_c", 0.3))
enh.load_state_dict(ckpt["enhancer"])
enh.eval()

os.makedirs(out_dir, exist_ok=True)
with open(scp_path) as f:
    ids = [l.strip() for l in f if l.strip() and not l.startswith("#")]
with torch.no_grad():
    for uid in ids:
        wave, _ = audio_io.load_mono_wave(
            os.path.join(data_root, "noisy_test", uid + ".wav"), sr)
        x = torch.from_numpy(np.asarray(wave, np.float32))[None]
        out, _ = enh(x)
        audio_io.write_wav(os.path.join(out_dir, uid + ".wav"),
                           out[0].numpy(), sr)
print("reference-enhanced", len(ids), "utterances")
"""


# ---------------------------------------------------------------------------
# stages

def stage_features(data_root: str, seg_s: float, sr: int, batch_size: int):
    """Stage 2: one padded segment batch of the train split and its TF
    features; raises unless every feature is finite. (batch, features)."""
    import torch

    from lct_gan_tpu_torch.data import ScpDataset, batch_iterator
    from lct_gan_tpu_torch.sigproc import (TFFeaturesConfig,
                                           compute_tf_features)

    ds = ScpDataset(data_root, "train.scp", "train", sample_rate=sr,
                    segment_length=int(seg_s * sr), random_segment=True,
                    seed=42)
    batch = next(iter(batch_iterator(ds, batch_size, pad_to_segment=True)))
    feats = compute_tf_features(
        torch.from_numpy(batch["noisy"]), torch.from_numpy(batch["clean"]),
        TFFeaturesConfig(n_fft=512, compress_input=False,
                         return_stfts=False))
    if not set(feats) >= {"noisy_mag", "irm_c", "noisy_mag_c"}:
        raise ValueError(f"features {sorted(feats)}")
    for k, v in feats.items():
        if not bool(torch.isfinite(v).all()):
            raise ValueError(f"{k} is not finite")
    return batch, feats


def _mean_metrics(clean_dir, enh_dir, ids, sr):
    import numpy as np

    from lct_gan_tpu_torch.metrics import compute_metrics_for_pair

    per = {}
    for uid in ids:
        m = compute_metrics_for_pair(
            os.path.join(clean_dir, uid + ".wav"),
            os.path.join(enh_dir, uid + ".wav"), sr)
        for k, v in m.items():
            if math.isfinite(v):
                per.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in per.items()}


def parity_gate(stage, data_root, scp_path, reference_pt, work, sr, device,
                log):
    """Enhance the test split with (a) the port serving the reference
    checkpoint (infer CLI, exact lengths), (b) the PyTorch reference itself
    (oracle child, torch on the CPU), score both against clean, and gate on
    the metric deltas."""
    from lct_gan_tpu_torch.metrics import pesq_available

    if REFERENCE_ROOT is None:
        return stage.fail("LCT_REFERENCE_ROOT is not set: the oracle needs "
                          "the reference's code")
    ours_dir = os.path.join(work, "gate_ours")
    ref_dir = os.path.join(work, "gate_reference")

    # --exact_lengths: the oracle runs each utterance at its exact length;
    # bucketed padding feeds the unmasked time attention padded frames.
    rc = _run_cli("lct_gan_tpu_torch.infer",
                  ["--data_root", data_root, "--checkpoint", reference_pt,
                   "--output_dir", ours_dir, "--exact_lengths",
                   "--sample_rate", str(sr), "--device", device],
                  os.path.join(work, "gate_ours.log"))
    if rc != 0:
        return stage.fail("our inference with the reference checkpoint "
                          "failed:\n"
                          + _tail(os.path.join(work, "gate_ours.log")))

    with open(os.path.join(work, "gate_reference.log"), "w") as lf:
        proc = subprocess.run(
            [sys.executable, "-c", _REF_INFER, REFERENCE_ROOT, REPO,
             reference_pt, data_root, scp_path, ref_dir, str(sr)],
            stdout=lf, stderr=subprocess.STDOUT,
            env=child_env(pythonpath=False), timeout=3600)
    if proc.returncode != 0:
        return stage.fail("reference (torch) inference failed:\n"
                          + _tail(os.path.join(work, "gate_reference.log")))

    ids = _test_ids(scp_path)
    clean_dir = os.path.join(data_root, "clean_test")
    ours = _mean_metrics(clean_dir, ours_dir, ids, sr)
    ref = _mean_metrics(clean_dir, ref_dir, ids, sr)

    print("  parity gate means (ours vs reference):", file=log)
    for k in sorted(set(ours) | set(ref)):
        print(f"    {k}: {ours.get(k, float('nan')):.4f} vs "
              f"{ref.get(k, float('nan')):.4f}", file=log)

    if pesq_available():
        gates = [("pesq_wb", 0.01)]
        mode = "PESQ gate"
    else:
        gates = [("si_sdr", 0.1), ("stoi", 0.001), ("fwsegsnr", 0.1)]
        mode = "waiver triple (pesq wheel absent)"
    fails, details = [], []
    for key, tol in gates:
        a, b = ours.get(key), ref.get(key)
        if a is None or b is None:
            fails.append(key)
            details.append(f"{key}: missing")
            continue
        d = abs(a - b)
        details.append(f"|d {key}|={d:.4f} (tol {tol})")
        if d > tol:
            fails.append(key)
    detail = f"{mode}: " + ", ".join(details)
    return stage.fail(detail) if fails else stage.ok(detail)


def report(stages: Sequence[Stage], seconds: float,
           out: Optional[TextIO] = None) -> int:
    """Print the verdict table, the VERDICT line and, last, the JSON line
    to `out` (default: stdout); return the exit code: 1 if any stage
    FAILed, else 0."""
    out = out or sys.stdout
    print(f"\n== acceptance verdict ({seconds:.0f}s) ==", file=out)
    width = max((len(s.desc) for s in stages), default=0)
    failed = any(s.status == "FAIL" for s in stages)
    for s in stages:
        detail = s.detail if "\n" not in s.detail else (
            "\n      " + s.detail.replace("\n", "\n      "))
        print(f"  [config {s.config}] {s.desc:<{width}} {s.status} "
              f"{s.seconds:6.1f}s  {detail}", file=out)
    verdict = "FAIL" if failed else "PASS"
    print(f"\nVERDICT: {verdict}", file=out)
    print(json.dumps({"verdict": verdict,
                      "stages": {s.config: s.status for s in stages}}),
          file=out, flush=True)
    return 1 if failed else 0


def _make_reference_pt(work: str):
    """A reference-initialised checkpoint written by the reference's own
    code, or None when that fails."""
    path = os.path.join(work, "reference_init.pt")
    with open(os.path.join(work, "make_ref_pt.log"), "w") as lf:
        proc = subprocess.run(
            [sys.executable, "-c", _MAKE_REF_PT, REFERENCE_ROOT, path],
            stdout=lf, stderr=subprocess.STDOUT,
            env=child_env(pythonpath=False), timeout=600)
    if proc.returncode != 0:
        print(_tail(os.path.join(work, "make_ref_pt.log")))
        return None
    return path


def run(args) -> int:
    t_start = time.time()
    work = args.work_dir or tempfile.mkdtemp(prefix="lct_acceptance_")
    os.makedirs(work, exist_ok=True)
    data_root = args.data_root
    seg_s = args.segment_seconds
    sr = args.sample_rate
    dev = ["--device", args.device]
    if args.synthetic:
        if data_root is None:
            data_root = os.path.join(work, "data")
            make_synthetic_tree(data_root, sr)
        if seg_s is None:
            seg_s = 0.25
    if data_root is None:
        print("ERROR: need --data_root or --synthetic", file=sys.stderr)
        return 2
    if seg_s is None:
        seg_s = 2.0
    scp_path = os.path.join(data_root, "test.scp")

    reference_pt = args.reference_pt
    if (reference_pt is None and args.synthetic
            and REFERENCE_ROOT is not None
            and os.path.isdir(REFERENCE_ROOT)):
        reference_pt = _make_reference_pt(work)

    stages: List[Stage] = []
    print(f"== acceptance run: data_root={data_root} work={work} "
          f"device={args.device}", flush=True)

    # ---- 2: feature pipeline on segment batches ----
    st = Stage("2", "STFT + tf_features on segment batches")
    try:
        batch, feats = stage_features(data_root, seg_s, sr, args.batch_size)
        stages.append(st.ok(f"batch {batch['noisy'].shape} -> irm_c "
                            f"{tuple(feats['irm_c'].shape)}"))
    except Exception as e:  # noqa: BLE001 -- reported in the verdict
        stages.append(st.fail(repr(e)))

    # ---- 3 + 4: training runs ----
    best_ckpt = args.checkpoint
    for config, gan_loss in (("3", "ls"), ("4", "hinge")):
        st = Stage(config, f"train_cli --gan_loss {gan_loss} + val loop")
        if args.skip_train:
            stages.append(st.skip("--skip_train"))
            continue
        expr = os.path.join(work, f"expr_{gan_loss}")
        log_path = os.path.join(work, f"train_{gan_loss}.log")
        rc = _run_cli(
            "lct_gan_tpu_torch.train_cli",
            ["--data_root", data_root, "--expr_root", expr,
             "--epochs", str(args.epochs), "--batch_size",
             str(args.batch_size), "--segment_seconds", str(seg_s),
             "--sample_rate", str(sr), "--gan_loss", gan_loss,
             "--seed", "42", "--val_interval", "1", "--ckpt_interval", "1",
             "--log_interval", "1", *dev],
            log_path)
        if rc != 0:
            stages.append(st.fail(_tail(log_path)))
            continue
        runs = sorted(os.listdir(expr))
        ckpt = os.path.join(expr, runs[-1], "ckpts", "best.pt")
        if not os.path.isfile(ckpt):
            stages.append(st.fail("no best checkpoint written"))
            continue
        if gan_loss == "ls" and best_ckpt is None:
            best_ckpt = ckpt
        csv = os.path.join(expr, runs[-1], "metrics.csv")
        stages.append(st.ok(f"best={ckpt} metrics.csv=yes")
                      if os.path.isfile(csv)
                      else st.fail("metrics.csv missing"))

    # ---- 1: inference over the test split ----
    st = Stage("1", "infer wav-in/wav-out over the test split")
    if best_ckpt is None:
        stages.append(st.skip("no checkpoint (training skipped/failed)"))
    else:
        out_dir = os.path.join(work, "enhanced_test")
        log_path = os.path.join(work, "infer.log")
        rc = _run_cli("lct_gan_tpu_torch.infer",
                      ["--data_root", data_root, "--checkpoint", best_ckpt,
                       "--output_dir", out_dir, "--sample_rate", str(sr),
                       *dev], log_path)
        if rc != 0:
            stages.append(st.fail(_tail(log_path)))
        else:
            ids = _test_ids(scp_path)
            missing = [u for u in ids if not os.path.isfile(
                os.path.join(out_dir, u + ".wav"))]
            mlog = os.path.join(work, "metrics.log")
            mrc = _run_cli("lct_gan_tpu_torch.metrics_cli",
                           ["--data_root", data_root, "--enhanced_dir",
                            out_dir, "--sample_rate", str(sr)], mlog)
            if missing or mrc != 0:
                stages.append(st.fail(f"missing={missing} metrics_rc={mrc}"))
            else:
                stages.append(st.ok(
                    f"{len(ids)} wavs + metrics_cli report:\n"
                    + _tail(mlog, 6).rstrip()))

    # ---- 5: data-parallel dry run + streaming inference ----
    st = Stage("5", "data-parallel step (2 ranks) + streaming inference")
    log_path = os.path.join(work, "dp_dryrun.log")
    rc = _run_cli("lct_gan_tpu_torch.entry", ["2", *dev], log_path)
    if rc != 0:
        stages.append(st.fail(_tail(log_path)))
    elif best_ckpt is None:
        stages.append(st.skip("DP dry run ok; no ckpt for streaming infer"))
    else:
        out_dir = os.path.join(work, "enhanced_stream")
        slog = os.path.join(work, "infer_stream.log")
        rc = _run_cli("lct_gan_tpu_torch.infer",
                      ["--data_root", data_root, "--checkpoint", best_ckpt,
                       "--output_dir", out_dir, "--sample_rate", str(sr),
                       "--chunk_seconds", "1.0", "--chunk_overlap", "0.25",
                       *dev], slog)
        stages.append(st.ok("DP dry run (2 ranks) + chunked streaming "
                            "inference")
                      if rc == 0 else st.fail(_tail(slog)))

    # ---- G: parity gate ----
    st = Stage("G", "reference-checkpoint parity gate")
    if reference_pt is None:
        stages.append(st.skip("no --reference_pt supplied"))
    else:
        stages.append(parity_gate(st, data_root, scp_path, reference_pt,
                                  work, sr, args.device, sys.stdout))

    rc = report(stages, time.time() - t_start)
    if not args.keep_work_dir and args.work_dir is None and rc == 0:
        shutil.rmtree(work, ignore_errors=True)
    return rc


def main(argv=None):
    sys.exit(run(parse_args(argv)))


if __name__ == "__main__":
    main()

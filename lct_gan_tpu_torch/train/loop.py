"""The epoch loop: experiment dirs, training, validation with metrics,
checkpoints, CSV logging, resume (`lct_gan_tpu/train/loop.py:51-377`).

The reference's experiment contract (train.py:525-733): a run directory
<expr_root>/<timestamp>/ holding ckpts/, configs.json and metrics.csv;
validation every val_interval epochs and on the final epoch; the best
checkpoint tracked by validation MR-STFT; `last` written every epoch,
`epoch_%04d` every ckpt_interval epochs, `best` on improvement.

Training batches are fixed-shape segments, shuffled and cropped by
(seed, epoch), decoded and copied to the device by a background
`Prefetcher`, so a resumed run sees the batches of an uninterrupted one.

Under a data-parallel `mesh` of W > 1 ranks (parallel/mesh.py), run by
every rank: each rank decodes and trains on its rows of each global batch,
the train step all-reduces the gradients, validation is sharded the same
way with its sums all-reduced, and rank 0 alone writes the run directory
while the others wait at a barrier.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from lct_gan_tpu_torch.data import Prefetcher, ScpDataset, batch_iterator
from lct_gan_tpu_torch.metrics.external import pesq_score, stoi_score
from lct_gan_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum_, barrier,
                                             broadcast_object,
                                             broadcast_state_, make_mesh)
from lct_gan_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from lct_gan_tpu_torch.train.state import TrainConfig, create_state
from lct_gan_tpu_torch.train.step import make_eval_step, make_train_step
from lct_gan_tpu_torch.utils import (append_csv_row, ensure_dir,
                                     now_timestamp, to_jsonable, write_json)

__all__ = ["DataConfig", "run_training", "validate"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_root: str
    train_scp: str = "train.scp"
    test_scp: str = "test.scp"
    num_prefetch: int = 4
    # Decode threads for batch_iterator (reference train.py:118/136
    # num_workers); also sizes the PESQ/STOI host scoring pool.
    num_workers: int = 4


def _pad_batch_to(batch: Dict[str, Any], size: int) -> Dict[str, Any]:
    """Pad the batch axis to `size` by repeating the last row; `lengths`
    marks the padded rows with 0."""
    b = batch["noisy"].shape[0]
    if b == size:
        return batch
    out = dict(batch)
    reps = size - b
    for k in ("noisy", "clean"):
        out[k] = np.concatenate(
            [batch[k], np.repeat(batch[k][-1:], reps, axis=0)], axis=0)
    out["lengths"] = np.concatenate(
        [batch["lengths"], np.zeros((reps,), dtype=np.int64)])
    return out


def _score_utterance(ref: np.ndarray, est: np.ndarray, sample_rate: int,
                     compute_pesq: bool, compute_stoi: bool):
    """Host PESQ / STOI of one utterance, swallowing failures as the
    reference does (train.py:343-364): NaN marks unavailable or failed."""
    p = s = float("nan")
    if compute_pesq:
        try:
            p = pesq_score(ref, est, sample_rate, "wb")
        except Exception:
            pass
    if compute_stoi:
        try:
            s = stoi_score(ref, est, sample_rate)
        except Exception:
            pass
    return p, s


def validate(eval_step, enhancer, val_ds: ScpDataset, cfg: TrainConfig,
             batch_size: int, compute_pesq: bool = True,
             compute_stoi: bool = True, num_workers: int = 4,
             adaptive_target_seconds: Optional[float] = None,
             max_batch: int = 128, batch_multiple: int = 1,
             mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Full-utterance validation (reference: train.py:285-385).

    MR-STFT and SI-SDR on the enhancer's device, length-masked, summed over
    the real rows only (a padded tail batch cannot bias the mean). PESQ /
    STOI are scored on a host thread pool while the next batches run on the
    device, and accumulated in submission order: the result is bit-equal
    to scoring each batch serially.

    adaptive_target_seconds: size each batch by its length bucket (at most
    max_batch rows), holding the padded batch near the target; a tail batch
    pads its rows up to the bucket's full row count, rounded up to a
    multiple of `batch_multiple`.

    mesh: with W > 1 ranks (every rank calls this), each rank runs and
    scores its rows of each padded global batch (batch_multiple a multiple
    of W), and the sums and counts are all-reduced in float64: every rank
    returns the global result.
    """
    adaptive = (int(adaptive_target_seconds * cfg.sample_rate)
                if adaptive_target_seconds else None)
    world = 1 if mesh is None else mesh.world
    shard = (mesh.rank, world) if world > 1 else None
    if world > 1 and (batch_multiple % world
                      or (not adaptive and batch_size % world)):
        raise ValueError(f"validation over {world} ranks needs batch_size "
                         f"({batch_size}) and batch_multiple "
                         f"({batch_multiple}) divisible by {world}")
    total_mr = 0.0
    total_si = 0.0
    count = 0
    futures = []

    def run(pool):
        nonlocal total_mr, total_si, count
        for batch in batch_iterator(val_ds,
                                    max_batch if adaptive else batch_size,
                                    bucket=True, sort_by_length=True,
                                    adaptive_target_samples=adaptive,
                                    num_workers=num_workers, shard=shard):
            # b: this rank's real rows (a prefix of the batch).
            b = batch.get("valid", batch["noisy"].shape[0])
            if adaptive:
                # Rows for this bucket: never below the global batch's own
                # rows, never above the validation set.
                bucket = batch["noisy"].shape[1]
                rows = max(batch.get("global_rows", b),
                           min(max_batch, adaptive // bucket, len(val_ds)))
                rows = -(-rows // batch_multiple) * batch_multiple
            else:
                rows = batch_size
            padded = _pad_batch_to(batch, rows // world)
            lengths = np.asarray(padded["lengths"])
            enhanced, m = eval_step(enhancer, padded["noisy"],
                                    padded["clean"], lengths)
            total_mr += float(m["mrstft"][:b].sum())
            total_si += float(m["si_sdr"][:b].sum())

            if compute_pesq or compute_stoi:
                enhanced = enhanced[:b].cpu().numpy()  # one copy per batch
                for i in range(b):
                    L = int(lengths[i])
                    if L <= 0:
                        continue
                    ref = np.array(batch["clean"][i, :L], copy=True)
                    est = np.array(enhanced[i, :L], copy=True)
                    futures.append(pool.submit(
                        _score_utterance, ref, est, cfg.sample_rate,
                        compute_pesq, compute_stoi))
            count += b

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        run(pool)
        scores = [f.result() for f in futures]

    total_pesq = n_pesq = 0
    total_stoi = n_stoi = 0
    for p, s in scores:
        if math.isfinite(p):
            total_pesq += p
            n_pesq += 1
        if math.isfinite(s):
            total_stoi += s
            n_stoi += 1
    if world > 1:
        sums = torch.tensor([total_mr, total_si, count, total_pesq, n_pesq,
                             total_stoi, n_stoi], dtype=torch.float64,
                            device=mesh.device)
        all_reduce_sum_([sums], mesh)
        (total_mr, total_si, count, total_pesq, n_pesq, total_stoi,
         n_stoi) = sums.tolist()

    return {
        "val_mrstft": total_mr / max(count, 1),
        "val_si_sdr": total_si / max(count, 1),
        "val_pesq": (total_pesq / n_pesq) if n_pesq else float("nan"),
        "val_stoi": (total_stoi / n_stoi) if n_stoi else float("nan"),
    }


class _StepClock:
    """Milliseconds between consecutive marks: CUDA events on the card
    (device time, including any wait for the next batch), the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []

    def mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def intervals_ms(self):
        if self._cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self._marks, self._marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self._marks, self._marks[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: TrainConfig,
                 data: DataConfig,
                 expr_root: str = "exprs",
                 resume: Optional[str] = None,
                 device="cuda",
                 compute_pesq: bool = True,
                 compute_stoi: bool = True,
                 profile_steps: int = 0,
                 mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Train LCT-GAN end to end on `device` (the card unless "cpu" is
    asked). `resume`: a checkpoint .pt (e.g. <run_dir>/ckpts/last.pt);
    the run continues in its run directory.

    mesh: this rank's data-parallel mesh (parallel.make_mesh; its device
    replaces `device`). With W > 1 ranks every rank calls this: batch_size
    must divide by W, each rank trains on its batch_size / W rows of each
    global batch, rank 0 writes configs.json (with "devices": W and the
    backend), metrics.csv, the log lines and the checkpoints, and every
    rank returns the same summary but its own timings.

    profile_steps > 0 writes a torch.profiler trace of steps 3 to
    3 + profile_steps of the first epoch to <run_dir>/profile/trace.json.

    Returns {"run_dir", "best_val", "best_epoch", "epochs"}: one entry per
    epoch with its steps, seconds, audio_sec_per_s, step_ms (one per step:
    mark to mark, so a step's wait for its batch is in it), val_seconds
    and ckpt_seconds.
    """
    if mesh is None:
        mesh = make_mesh(1, device)
    dev, world, main = mesh.device, mesh.world, mesh.is_main
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible "
                         f"by the {world} data-parallel ranks")
    log = print if main else (lambda *a, **k: None)
    if dev.type == "cuda":
        # Deterministic cuDNN before the first conv of the run, so a
        # resumed run repeats an uninterrupted one bit for bit.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    # ---- Experiment dirs (train.py:529-549) ----
    if resume is not None:
        resume_path = os.path.abspath(resume)
        ckpt_dir = os.path.dirname(resume_path)
        run_dir = os.path.dirname(ckpt_dir)
        if os.path.basename(ckpt_dir) != "ckpts":
            ckpt_dir = os.path.join(run_dir, "ckpts")
        log(f"Resuming from: {resume_path}")
        log(f"Using existing run_dir: {run_dir}")
    else:
        run_dir = broadcast_object(
            os.path.join(expr_root, now_timestamp()), mesh)
        ckpt_dir = os.path.join(run_dir, "ckpts")
    if main:
        ensure_dir(run_dir)
        ensure_dir(ckpt_dir)
    configs_path = os.path.join(run_dir, "configs.json")
    metrics_csv = os.path.join(run_dir, "metrics.csv")

    # ---- Data ----
    train_ds = ScpDataset(
        data.data_root, data.train_scp, "train",
        sample_rate=cfg.sample_rate, segment_length=cfg.segment_length,
        random_segment=True, seed=cfg.seed)
    val_ds = ScpDataset(
        data.data_root, data.test_scp, "test",
        sample_rate=cfg.sample_rate, segment_length=None,
        random_segment=False)

    # ---- State / steps ----
    train_step = make_train_step(cfg, mesh)
    eval_step = make_eval_step(cfg)
    start_epoch = 1
    best_val = float("inf")
    best_epoch = 0
    if resume is not None:
        state, meta = restore_checkpoint(resume_path, cfg, device=dev)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_val = float(meta.get("best_val", float("inf")))
        best_epoch = int(meta.get("best_epoch", 0))
        log(f"Resumed at epoch {start_epoch} "
            f"(best_val={best_val:.4f} from epoch {best_epoch}).")
    else:
        state = create_state(cfg, device=dev)
        if main:
            write_json(configs_path, {
                "run_dir": run_dir,
                "created_at": now_timestamp(),
                "train_cfg": to_jsonable(cfg),
                "data_cfg": to_jsonable(data),
                "device": str(dev),
                "devices": world,
                "backend": mesh.backend,
            })
            print(f"Saved configs to: {configs_path}")
    broadcast_state_(state, mesh)  # rank 0's state on every rank
    shard = (mesh.rank, world) if world > 1 else None

    # ---- Epoch loop (train.py:651-731) ----
    epochs = []
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.time()
        clock = _StepClock(dev)
        clock.mark()
        it = Prefetcher(
            batch_iterator(train_ds, cfg.batch_size, shuffle=True,
                           drop_last=True, pad_to_segment=True,
                           seed=cfg.seed, epoch=epoch,
                           num_workers=data.num_workers, shard=shard),
            depth=data.num_prefetch, device=dev)
        prof = None
        n_steps = 0
        with torch.profiler.record_function("train_epoch"):
            for step_idx, batch in enumerate(it, 1):
                if (profile_steps and main and epoch == start_epoch
                        and step_idx == 3):
                    prof = _start_profile(dev)
                metrics = train_step(state, batch["noisy"], batch["clean"])
                clock.mark()
                if prof is not None and step_idx == 3 + profile_steps:
                    _stop_profile(prof, dev, run_dir)
                    prof = None
                n_steps += 1
                if main and step_idx % cfg.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"[Epoch {epoch:03d} Step {step_idx:05d}] "
                          f"D_loss={m['d_loss']:.4f} | "
                          f"G_loss={m['g_loss']:.4f} | "
                          f"MR={m['mr_loss']:.4f} | "
                          f"Mask={m['mask_loss']:.4f} | "
                          f"Adv={m['adv_loss']:.4f} | "
                          f"FM={m['fm_loss']:.4f}")
            if prof is not None:  # the epoch ended inside the window
                _stop_profile(prof, dev, run_dir)
            _sync(dev)
        dt = time.time() - t0
        audio_rate = n_steps * cfg.batch_size * cfg.segment_seconds / dt
        if n_steps:
            log(f"[Epoch {epoch:03d}] {n_steps} steps in {dt:.1f}s "
                f"({audio_rate:.1f} audio-sec/s)")
        record = {"epoch": epoch, "steps": n_steps, "seconds": dt,
                  "audio_sec_per_s": audio_rate,
                  "step_ms": clock.intervals_ms(), "val_seconds": None}

        do_val = (epoch % max(cfg.val_interval, 1) == 0) or (
            epoch == cfg.epochs)
        val_metrics: Dict[str, float] = {}
        improved = False
        if do_val:
            t_val = time.time()
            val_metrics = validate(
                eval_step, state.enhancer, val_ds, cfg, cfg.batch_size,
                compute_pesq=compute_pesq, compute_stoi=compute_stoi,
                num_workers=data.num_workers,
                adaptive_target_seconds=(cfg.val_target_batch_seconds
                                         or None),
                batch_multiple=world, mesh=mesh)
            record["val_seconds"] = time.time() - t_val
            msg = (f"[Epoch {epoch:03d}] Val MR-STFT="
                   f"{val_metrics['val_mrstft']:.4f} | "
                   f"SI-SDR={val_metrics['val_si_sdr']:.3f}")
            if math.isfinite(val_metrics["val_pesq"]):
                msg += f" | PESQ={val_metrics['val_pesq']:.3f}"
            if math.isfinite(val_metrics["val_stoi"]):
                msg += f" | STOI={val_metrics['val_stoi']:.4f}"
            log(msg)
            if val_metrics["val_mrstft"] < best_val:
                best_val = val_metrics["val_mrstft"]
                best_epoch = epoch
                improved = True

        meta = {"epoch": epoch, "best_val": best_val,
                "best_epoch": best_epoch, "val_metrics": val_metrics,
                "train_cfg": to_jsonable(cfg)}
        t_ckpt = time.time()
        if main:
            save_checkpoint(ckpt_dir, "last", state, meta)
            if ((epoch % max(cfg.ckpt_interval, 1) == 0)
                    or (epoch == cfg.epochs)):
                save_checkpoint(ckpt_dir, f"epoch_{epoch:04d}", state, meta)
            if do_val and improved:
                save_checkpoint(ckpt_dir, "best", state, meta)
                print(f"New best val MR-STFT: {best_val:.4f} @ epoch "
                      f"{best_epoch} (saved best)")
        barrier(mesh)
        record["ckpt_seconds"] = time.time() - t_ckpt
        if do_val and main:
            append_csv_row(metrics_csv, {
                "epoch": epoch,
                **val_metrics,
                "best_val_mrstft": best_val,
                "best_epoch": best_epoch,
            })
        epochs.append(record)

    log("Training finished.")
    return {"run_dir": run_dir, "best_val": best_val,
            "best_epoch": best_epoch, "epochs": epochs}


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, dev: torch.device, run_dir: str) -> None:
    _sync(dev)
    prof.stop()
    out = os.path.join(ensure_dir(os.path.join(run_dir, "profile")),
                       "trace.json")
    prof.export_chrome_trace(out)
    print(f"Saved device trace to {out}")


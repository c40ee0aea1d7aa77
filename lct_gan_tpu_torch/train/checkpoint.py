"""Training checkpoints in the reference's `.pt` format (the counterpart of
`lct_gan_tpu/train/checkpoint.py`).

One `torch.save` per checkpoint, with the reference's payload keys
(reference train.py:690-704):

  epoch, best_val, best_epoch     the run's counters
  enhancer, mpd, msd              state_dicts (spectral-norm u / v buffers
                                  included)
  g_opt, d_opt                    the two AdamW state_dicts
  step, val_metrics               optimisation steps, last validation
  args                            the TrainConfig as plain JSON types: its
                                  compress_c and max_time_context are what
                                  `load_enhancer` reads

Only plain Python types and tensors are stored, so every consumer can load
it with `torch.load(..., weights_only=True)`: resume, `load_enhancer`, and
the JAX package's `state_from_torch_checkpoint`; tensors are saved where
they live and every reader maps them to the CPU. Files live under
<run_dir>/ckpts/ as last.pt, epoch_%04d.pt and best.pt and are written
atomically (a temporary file, then os.replace).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from lct_gan_tpu_torch.train.state import (GanTrainState, TrainConfig,
                                           create_state)
from lct_gan_tpu_torch.utils.config import ensure_dir, to_jsonable

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "read_checkpoint_meta"]

_META_KEYS = ("epoch", "best_val", "best_epoch", "step", "val_metrics",
              "args")


def _plain(obj: Any) -> Any:
    """JSON types only (numpy scalars become floats; NaN and inf stay):
    what weights_only unpickling accepts."""
    return json.loads(json.dumps(to_jsonable(obj)))


def save_checkpoint(ckpt_dir: str, name: str, state: GanTrainState,
                    meta: Mapping[str, Any]) -> str:
    """Write <ckpt_dir>/<name>.pt (replacing it). `meta` holds epoch,
    best_val, best_epoch, val_metrics and train_cfg (a TrainConfig or its
    dict)."""
    ensure_dir(ckpt_dir)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    payload = {
        "epoch": int(meta.get("epoch", 0)),
        "best_val": float(meta.get("best_val", float("inf"))),
        "best_epoch": int(meta.get("best_epoch", 0)),
        "enhancer": state.enhancer.state_dict(),
        "mpd": state.mpd.state_dict(),
        "msd": state.msd.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "step": int(state.step),
        "val_metrics": _plain(meta.get("val_metrics", {})),
        "args": _plain(meta.get("train_cfg", {})),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, cfg: TrainConfig, device="cuda"
                       ) -> Tuple[GanTrainState, Dict[str, Any]]:
    """(state on `device`, meta) from a checkpoint. The models are built
    and moved to the device first and the optimizer state_dicts loaded
    after, so AdamW's moments land on the parameters' device."""
    ckpt = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    state = create_state(cfg, device=device)
    state.enhancer.load_state_dict(ckpt["enhancer"], strict=True)
    state.mpd.load_state_dict(ckpt["mpd"], strict=True)
    state.msd.load_state_dict(ckpt["msd"], strict=True)
    state.g_opt.load_state_dict(ckpt["g_opt"])
    state.d_opt.load_state_dict(ckpt["d_opt"])
    state.step = int(ckpt.get("step", 0))
    return state, _meta(ckpt)


def _meta(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    meta = {k: ckpt[k] for k in _META_KEYS if k in ckpt}
    meta["train_cfg"] = meta.pop("args", {}) or {}
    return meta


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """<ckpt_dir>/last.pt, or None when there is none."""
    p = os.path.join(ckpt_dir, "last.pt")
    return p if os.path.isfile(p) else None


def read_checkpoint_meta(checkpoint: str) -> Dict[str, Any]:
    """The meta of a `.pt` checkpoint: epoch, best_val, best_epoch, step,
    val_metrics and train_cfg (the payload's `args`). A generator `.npz`
    carries its meta inside (`convert.read_npz_params`)."""
    return _meta(torch.load(checkpoint, map_location="cpu",
                            weights_only=True))

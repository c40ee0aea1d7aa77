"""Device resolution: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import subprocess
from typing import Union

import torch

__all__ = ["resolve_device", "disable_tf32", "gpu_name_and_power_limit"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return `device` as a torch.device. A CUDA device without a visible
    GPU raises: no entry point falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is visible; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card (a card set below its maximum power runs slower, so every
    number this port records stands beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def disable_tf32() -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), which would put the port's encoder/decoder outside the JAX
    reference's f32 numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

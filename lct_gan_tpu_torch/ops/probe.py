"""Rate of the card's special-function unit, measured.

With head_dim 16 the bf16 attention kernels are paced by their exps, not by
their products, so `chip_smoke.py` prints an exp floor beside each kernel's
bound: the kernel's exp count over the rate this probe measures on the same
card in the same run (`csrc/probe.cu`: independent chains of the `ex2`
instruction the kernels use, on every SM). Not on any path of the model, and
there is nothing to compute on the CPU: it raises there.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["ex2_rate"]

_P = ctypes.c_void_p


def ex2_rate(device="cuda", iters: int = 4096, reps: int = 3) -> float:
    """Exps per second: the best of `reps` timed launches, each of 8 blocks
    of 256 threads per SM running `iters` steps of the probe's chains."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"ex2_rate measures a CUDA card, got {dev}")
    from lct_gan_tpu_torch.ops._build import (kernel_function, load_library,
                                              raise_on_error)

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    threads = 256
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    chains = load_library("probe").lct_ex2_chains()
    out = torch.empty(blocks * threads, device=dev, dtype=torch.float32)
    fn = kernel_function("probe", "lct_ex2_rate_probe",
                         [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, _P])
    stream = torch.cuda.current_stream(dev)

    def launch():
        raise_on_error(fn(out.data_ptr(), blocks, threads, iters, dev.index,
                          stream.cuda_stream), "probe", "ex2 rate probe")

    launch()  # warm-up
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    if not torch.isfinite(out).all():
        raise RuntimeError("ex2 rate probe wrote non-finite values")
    return blocks * threads * iters * chains / best

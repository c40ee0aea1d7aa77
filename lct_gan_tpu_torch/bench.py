"""Enhancement throughput of the port on the card (audio-sec/s).

    python -m lct_gan_tpu_torch.bench          # B=128 x 2 s seeded noise
    python -m lct_gan_tpu_torch.bench --full   # 256 seeded 1.5-10 s utterances
    python -m lct_gan_tpu_torch.bench [--full] --max_time_context 64

The two workloads are the JAX package's `bench.py` `run_fixed` and
`run_full`: the same batch, the same seeded utterance lengths, the same
length-sorted adaptive batching (`adaptive_slices(..., 128 * 32000, 128)`)
and bucket padding with per-row `lengths`, counting true audio seconds.
Weights are fixed (the committed demo checkpoint by default); each timing
loop ends in a device synchronize and the median of 3 is reported.
--max_time_context W serves banded-causal time attention in both workloads
(the JAX bench's flag); without it the checkpoint's setting applies (full
attention for the demo weights).

Prints ONE JSON line on stdout, with the card's `nvidia-smi` name and power
limit under "device"; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BATCH = 128
SECONDS = 2.0
SR = 16000
ITERS = 10
REPS = 3
FULL_N_UTTS = 256
FULL_TARGET_SAMPLES = 128 * 32000
FULL_MAX_BATCH = 128
DEFAULT_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "train_demo", "g_params_best.npz")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def full_utterance_lengths(n=FULL_N_UTTS, sr=SR, seed=7):
    """Seeded utterance lengths (samples), 1.5-10 s (the JAX bench's)."""
    rng = np.random.default_rng(seed)
    secs = np.clip(rng.gamma(4.0, 1.1, size=n), 1.5, 10.0)
    return [int(s * sr) for s in secs]


def full_batches(seed=11):
    """[(noisy [B, T_bucket] f32, lengths [B] int64)] and the true audio
    seconds of the --full workload."""
    from lct_gan_tpu_torch.data import adaptive_slices, bucket_length

    rng = np.random.default_rng(seed)
    lens = sorted(full_utterance_lengths())
    batches, total = [], 0.0
    for i, j in adaptive_slices(lens, FULL_TARGET_SAMPLES, FULL_MAX_BATCH):
        chunk = lens[i:j]
        x = np.zeros((len(chunk), bucket_length(max(chunk))), np.float32)
        for r, L in enumerate(chunk):
            x[r, :L] = 0.1 * rng.standard_normal(L)
        batches.append((x, np.asarray(chunk, np.int64)))
        total += sum(chunk) / SR
    return batches, total


def _timed(fn, sync):
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


_GROUPS = (  # lower-case kernel-name fragment -> layer, first match wins
    ("gru_tc_kernel", "FTF block: LN1 + GRU (tensor cores)"),
    ("banded_tc_kernel", "banded attention, qkv + band + out-proj fused "
     "(tensor cores)"),
    ("qkv_tc_kernel", "(FTF: LN2 +) qkv projection (tensor cores)"),
    ("attn_tc_kernel", "attention + epilogue products (tensor cores)"),
    ("ftf_out_kernel", "FTF block: out-proj + Linear"),
    ("gru_kernel", "GRU recurrence (FTF block + composed block)"),
    ("banded_attn_kernel", "banded attention core (precise)"),
    ("attn_kernel", "attention core (FTF + MHSA)"),
    ("proj_kernel", "LN + projections (FTF + MHSA + banded + composed "
     "GRU)"),
    ("fft", "STFT / iSTFT FFTs"),
    ("fprop", "encoder / decoder convs"),
    ("dgrad", "encoder / decoder convs"),
    ("conv", "encoder / decoder convs"),
    ("nchwtonhwc", "encoder / decoder convs"),
    ("nhwctonchw", "encoder / decoder convs"),
    ("gemm", "plain GEMMs (composed block's Linear)"),
)


def profile_step(step, sync) -> dict:
    """Device time of one `step()` by kernel and by layer (kernel-name
    groups), from torch.profiler, beside its host-clock wall time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type.name == "CUDA":
            kernels.append({"name": evt.key[:120], "calls": evt.count,
                            "device_ms": us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    groups: dict = {}
    for k in kernels:
        low = k["name"].lower()
        layer = next((g for frag, g in _GROUPS if frag in low),
                     "elementwise / other")
        groups[layer] = groups.get(layer, 0.0) + k["device_ms"]
    busy = sum(k["device_ms"] for k in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_layer_ms": dict(sorted(groups.items(), key=lambda g: -g[1])),
            "top_kernels": kernels[:25]}


def launches_per_pass(step, sync) -> dict:
    """Kernel launches of one untimed `step()`, by kernel wrapper (0 each on
    the CPU, where the wrappers compute their plain versions)."""
    from lct_gan_tpu_torch.ops import (banded_mhsa, fused_ftf_block,
                                       fused_grouped_gru, fused_mhsa)

    wrappers = (fused_ftf_block, fused_mhsa, banded_mhsa, fused_grouped_gru)
    for w in wrappers:
        w.launches = 0
    step()
    sync()
    return {w.__name__: w.launches for w in wrappers}


def run(full: bool, checkpoint: str, device: str,
        profile_path: str = None, max_time_context: int = None) -> dict:
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.utils import (gpu_name_and_power_limit,
                                         resolve_device)

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    enhance = make_enhance(load_enhancer(checkpoint, device=dev,
                                         max_time_context=max_time_context))
    if max_time_context is not None:
        log(f"banded time attention: max_time_context={max_time_context}")
    if full:
        host, audio_sec = full_batches()
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(ln).to(dev))
                   for x, ln in host]
        log(f"--full: {len(batches)} batches, {audio_sec:.1f} s audio, "
            f"shapes {sorted({tuple(x.shape) for x, _ in batches})}")

        def step():
            for x, ln in batches:
                enhance(x, ln)
        metric = "full_utterance_throughput"
    else:
        rng = np.random.default_rng(1)
        wave = torch.from_numpy((0.1 * rng.standard_normal(
            (BATCH, int(SECONDS * SR)))).astype(np.float32)).to(dev)
        audio_sec = BATCH * SECONDS * ITERS

        def step():
            for _ in range(ITERS):
                enhance(wave)
        metric = "enhanced_audio_throughput"
    log(f"first pass: {_timed(step, sync):.3f} s")
    log(f"warm pass: {_timed(step, sync):.3f} s")
    values = []
    for rep in range(REPS):
        dt = _timed(step, sync)
        values.append(audio_sec / dt)
        log(f"rep {rep + 1}/{REPS}: {audio_sec:.1f} audio-s in {dt:.3f} s "
            f"({values[-1]:.1f} audio-s/s)")
    card = gpu_name_and_power_limit() if dev.type == "cuda" else "cpu"
    result = {"metric": metric, "value": sorted(values)[len(values) // 2],
              "unit": "audio-sec/sec/chip", "reps": values,
              "max_time_context": max_time_context,
              "launches_per_pass": launches_per_pass(step, sync),
              "device": card}
    if profile_path:
        prof = {**profile_step(step, sync), "metric": metric, "device": card,
                "audio_sec": audio_sec}
        os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                    exist_ok=True)
        with open(profile_path, "w", encoding="utf-8") as f:
            json.dump(prof, f, indent=1)
        log(f"profile -> {profile_path}: busy {prof['device_busy_ms']:.1f} "
            f"of {prof['wall_ms']:.1f} ms; {prof['by_layer_ms']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="bucketed full-utterance workload (1.5-10 s)")
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="after timing, profile one pass (torch.profiler) "
                         "and write device time by kernel and layer to PATH")
    ap.add_argument("--max_time_context", type=int, default=None,
                    help="banded-causal time-attention lookback (frames); "
                         "default: the checkpoint's (full attention for the "
                         "demo weights)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.full, args.checkpoint, args.device,
                         args.profile, args.max_time_context)), flush=True)


if __name__ == "__main__":
    main()

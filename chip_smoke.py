#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):

  device   require CUDA; print the card's nvidia-smi name and power limit
  build    build the CUDA kernels from lct_gan_tpu_torch/csrc (nvcc, sm_90a)
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's shapes, in bf16 and precise (all-f32) modes: max|diff|
           against the stated tolerance, kernel / plain / library ms, bound
  enhance  the committed demo weights through load_enhancer + make_enhance:
           B=128 x 2 s (3 FTF launches, 0 MHSA; matches the plain path run
           on the CPU) and one bucketed batch of 163,840 samples with
           lengths (2 FTF launches, 1 MHSA; rows match the CPU plain path)

then the "kernels" summary line and, last, {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "train_demo",
                          "g_params_best.npz")
SR = 16000

# Kernel vs plain version on the same inputs, both on the card.
#   precise: both all-f32; only the order of f32 sums and the last ulp of
#     exp/tanh/rsqrt differ.
#   bf16: both round the same operands to bf16; a sum order that lands an
#     intermediate on the other side of a bf16 rounding boundary moves it by
#     one bf16 ulp (2^-8 relative). 3e-2 is the JAX package's own band for
#     its bf16 kernel (tests/test_pallas_ftf.py); a wiring fault is O(1).
TOL = {"precise": 1e-3, "bf16": 3e-2}
# Enhancer on the card (kernels) vs on the CPU (plain path), both bf16 mode:
# the mask is a sigmoid in [0, 1], the waveform ~0.1 * N(0, 1) input times a
# decompressed mask (d(m^(1/0.3)) <= 3.4 dm).
TOL_MASK = 2e-2
TOL_WAVE = 1e-2

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "precise": 67e12}   # tensor-core bf16; f32


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def band_pairs(L, lookback):
    """(query, key) pairs one head scores in one sequence."""
    if lookback is None:
        return L * L
    return sum(min(q, lookback) + 1 for q in range(L))


def bound(rows, flops, extra_bytes, mode):
    nbytes = 2 * rows * 64 * 4 + extra_bytes   # x read + out written
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[mode]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_attention_ms(torch, N, L, lookback, key_bias, mode):
    """One scaled_dot_product_attention call on the same attention shapes
    (a yardstick only: the port never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((N, 4, L, 16), generator=g, device="cuda",
                           dtype=dt) for _ in range(3))
    mask = None
    if key_bias is not None:
        mask = key_bias[:, None, None, :].to(dt)
    if lookback is not None:
        pos = torch.arange(L, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] >= pos[:, None] - lookback))
    ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 5)
    del q, k, v, mask
    return ms


def check_kernels(torch, enhancer):
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)
    from lct_gan_tpu_torch.ops.gru import grouped_gru

    gen = enhancer.gen
    g = torch.Generator(device="cuda").manual_seed(1234)

    def masked_tail(N, L, n_valid_min):
        valid = torch.randint(n_valid_min, L + 1, (N,), generator=g,
                              device="cuda")
        pos = torch.arange(L, device="cuda")
        return torch.where(pos[None, :] < valid[:, None], 0.0,
                           -1e30).to(torch.float32)

    results = {"fused_ftf_block": [], "fused_mhsa": []}
    ftf_cases = [
        # name, block, N, L, key_bias?, lookback  (B=128 x 2 s shapes)
        ("freq", gen.GRUf1, 128 * 129, 33, False, None),
        ("time_keybias", gen.GRUt1, 128 * 33, 129, True, None),
        ("time_lookback16", gen.GRUt1, 128 * 33, 129, False, 16),
    ]
    for name, block, N, L, use_kb, lookback in ftf_cases:
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kb = masked_tail(N, L, L - 40) if use_kb else None
        rows = N * L
        lin_in = params[12].shape[0]
        flops = rows * (2 * 2 * D * 192 * 16 + 2 * 64 * 192 + 2 * 64 * 64
                        + 2 * lin_in * 64) + N * 4 * band_pairs(L, lookback) * 64
        extra = sum(p.numel() for p in params) * 4 + (rows * 4 if use_kb else 0)
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=D == 2, num_heads=4, lookback=lookback,
                      key_bias=kb, precise=mode == "precise")
            out = fused_ftf_block(x, *params, **kw)
            torch.cuda.synchronize()
            ref = ftf_block_reference(x, *params, **kw)
            err = (out - ref).abs().max().item()
            if not (err <= TOL[mode]) or not torch.isfinite(out).all():
                raise AssertionError(f"fused_ftf_block {name} {mode}: "
                                     f"max|diff| {err} > {TOL[mode]}")
            ms = cuda_ms(torch, lambda: fused_ftf_block(x, *params, **kw), 5)
            plain_ms = cuda_ms(
                torch, lambda: ftf_block_reference(x, *params, **kw), 2)
            bms, by = bound(rows, flops, extra, mode)
            res = {"case": name, "mode": mode, "N": N, "L": L,
                   "max_abs_err": err, "tol": TOL[mode], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": library_attention_ms(torch, N, L, lookback,
                                                      kb, mode),
                   "flops": flops}
            results["fused_ftf_block"].append(res)
            emit({"phase": "kernels", "kernel": "fused_ftf_block", **res})
            del out, ref
        del x, kb
        torch.cuda.empty_cache()

    attn = gen.GRUt1.attn
    aparams = [p.detach().contiguous() for p in attn.kernel_params()]
    # Time block of the 131,072- and 163,840-sample buckets (adaptive rows
    # 4,096,000 // bucket = 31 and 25; bottleneck L = 516 and 644).
    for B, L in ((31, 516), (25, 644)):
        N = B * 33
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kb = masked_tail(N, L, L - 130)
        rows = N * L
        flops = rows * (2 * 64 * 192 + 2 * 64 * 64) + N * 4 * L * L * 64
        extra = sum(p.numel() for p in aparams) * 4 + rows * 4
        for mode in ("bf16", "precise"):
            kw = dict(num_heads=4, key_bias=kb, precise=mode == "precise")
            out = fused_mhsa(x, *aparams, **kw)
            torch.cuda.synchronize()
            ref = mhsa_reference(x, *aparams, **kw)
            err = (out - ref).abs().max().item()
            if not (err <= TOL[mode]) or not torch.isfinite(out).all():
                raise AssertionError(f"fused_mhsa L={L} {mode}: max|diff| "
                                     f"{err} > {TOL[mode]}")
            del ref
            torch.cuda.empty_cache()
            ms = cuda_ms(torch, lambda: fused_mhsa(x, *aparams, **kw), 3)
            plain_ms = cuda_ms(
                torch, lambda: mhsa_reference(x, *aparams, **kw), 1)
            torch.cuda.empty_cache()
            bms, by = bound(rows, flops, extra, mode)
            res = {"case": f"L{L}_keybias", "mode": mode, "N": N, "L": L,
                   "max_abs_err": err, "tol": TOL[mode], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": library_attention_ms(torch, N, L, None, kb,
                                                      mode),
                   "flops": flops}
            results["fused_mhsa"].append(res)
            emit({"phase": "kernels", "kernel": "fused_mhsa", **res})
            del out
        # The composed time block's grouped GRU at the same shape: a plain
        # torch loop (the port of the JAX package's lax.scan), timed only.
        gru = [p.detach() for p in gen.GRUt1.kernel_params()[2:6]]
        emit({"phase": "kernels", "plain": "grouped_gru (composed path)",
              "N": N, "L": L, "ms": cuda_ms(
                  torch, lambda: grouped_gru(x, *gru, bidirectional=False),
                  2)})
        del x, kb
        torch.cuda.empty_cache()
    return results


def run_counted(torch, enhance, x, lengths, expect):
    """One main-path call with every launch count set to 0 just before and
    read just after; raises unless the counts are `expect`."""
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block

    fused_ftf_block.launches = 0
    fused_mhsa.launches = 0
    out = enhance(x, lengths)
    torch.cuda.synchronize()
    got = {"fused_ftf_block": fused_ftf_block.launches,
           "fused_mhsa": fused_mhsa.launches}
    if got != expect:
        raise AssertionError(f"launch counts {got}, expected {expect}")
    return out, got


def check_enhance(torch, np, card, enhancer):
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import bucket_length
    from lct_gan_tpu_torch.eval import make_enhance

    cpu_enhancer = load_enhancer(CHECKPOINT, device="cpu")
    enhance = make_enhance(enhancer)
    launches = {"fused_ftf_block": 0, "fused_mhsa": 0}
    rng = np.random.default_rng(1)

    # Workload 1: B=128 x 2 s seeded noise (the fixed bench workload).
    wave = (0.1 * rng.standard_normal((128, 2 * SR))).astype(np.float32)
    x = torch.from_numpy(wave).cuda()
    enhance(x)  # warm-up
    out, got = run_counted(torch, enhance, x, None,
                           {"fused_ftf_block": 3, "fused_mhsa": 0})
    for k in launches:
        launches[k] += got[k]
    if not torch.isfinite(out).all() or tuple(out.shape) != (128, 2 * SR):
        raise AssertionError(f"enhance output bad: {tuple(out.shape)}")
    with torch.inference_mode():
        mask_gpu = enhancer(x)[1].cpu()
        t0 = time.perf_counter()
        ref_wave, ref_mask = cpu_enhancer(torch.from_numpy(wave))
        cpu_s = time.perf_counter() - t0
    werr = (out.cpu() - ref_wave).abs().max().item()
    merr = (mask_gpu - ref_mask).abs().max().item()
    if not (werr <= TOL_WAVE and merr <= TOL_MASK):
        raise AssertionError(f"enhance vs CPU plain path: wave {werr} "
                             f"(tol {TOL_WAVE}), mask {merr} (tol {TOL_MASK})")
    ms = cuda_ms(torch, lambda: enhance(x), 5)
    emit({"phase": "enhance", "workload": "fixed B=128 x 2 s",
          "launches": got, "wave_max_abs_err_vs_cpu": werr,
          "mask_max_abs_err_vs_cpu": merr, "tol_wave": TOL_WAVE,
          "tol_mask": TOL_MASK, "cpu_plain_s": cpu_s, "ms_per_call": ms,
          "audio_sec_per_s": 128 * 2.0 / (ms / 1e3), "device": card})

    # Workload 2: one bucketed batch of the 163,840-sample bucket.
    T = 163840
    B = 128 * 32000 // T
    lens = rng.integers(131073, T + 1, size=B)
    if any(bucket_length(int(n)) != T for n in lens):
        raise AssertionError("lengths outside the 163,840-sample bucket")
    wave = np.zeros((B, T), np.float32)
    for r, n in enumerate(lens):
        wave[r, :n] = 0.1 * rng.standard_normal(n)
    x = torch.from_numpy(wave).cuda()
    ln = torch.from_numpy(lens.astype(np.int64)).cuda()
    enhance(x, ln)  # warm-up
    out, got = run_counted(torch, enhance, x, ln,
                           {"fused_ftf_block": 2, "fused_mhsa": 1})
    for k in launches:
        launches[k] += got[k]
    if not torch.isfinite(out).all() or tuple(out.shape) != (B, T):
        raise AssertionError(f"bucketed output bad: {tuple(out.shape)}")
    with torch.inference_mode():
        ref_wave, _ = cpu_enhancer(torch.from_numpy(wave[:2]),
                                   torch.from_numpy(lens[:2].astype(np.int64)))
    werr = (out[:2].cpu() - ref_wave).abs().max().item()
    if not werr <= TOL_WAVE:
        raise AssertionError(f"bucketed rows vs CPU plain path: {werr}")
    ms = cuda_ms(torch, lambda: enhance(x, ln), 3)
    emit({"phase": "enhance", "workload": f"bucketed B={B} x {T} samples",
          "launches": got, "wave_max_abs_err_vs_cpu_rows01": werr,
          "tol_wave": TOL_WAVE, "ms_per_call": ms,
          "audio_sec_per_s": float(lens.sum()) / SR / (ms / 1e3),
          "device": card})
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA GPU visible")
    sys.path.insert(0, ROOT)
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.utils import (disable_tf32,
                                         gpu_name_and_power_limit)

    t_start = time.perf_counter()
    disable_tf32()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    build_s = build_all(verbose=True)
    emit({"phase": "build", "seconds": build_s})

    enhancer = load_enhancer(CHECKPOINT, device="cuda")
    kernels = check_kernels(torch, enhancer)
    launches = check_enhance(torch, np, card, enhancer)

    summary = []
    for name, src, replaces in (
            ("fused_ftf_block", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/ftf.py:132"),
            ("fused_mhsa", "lct_gan_tpu_torch/csrc/mhsa.cu",
             "lct_gan_tpu/ops/attention.py:125")):
        head = kernels[name][0] if name == "fused_ftf_block" else next(
            r for r in kernels[name] if r["L"] == 644 and r["mode"] == "bf16")
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "case": f"{head['case']} {head['mode']}",
            "cases": kernels[name]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "device": card})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

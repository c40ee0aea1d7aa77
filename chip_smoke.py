#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):

  device   require CUDA; print the card's nvidia-smi name and power limit
  build    build the CUDA kernels from lct_gan_tpu_torch/csrc (nvcc, sm_90a)
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's shapes, in bf16 and precise (all-f32) modes: max|diff|
           against the stated tolerance, kernel / plain / library ms, bound;
           the FTF and MHSA lines name the kernel design that ran (tc-bf16:
           tensor cores; simt-f32: CUDA cores) and the floor set by their
           exps at the exp rate measured on the card first
           (ops/probe.py), and MHSA is also timed against one
           multi_head_attention_forward call
           (banded_mhsa at the banded time blocks of the 196,608- and
           917,504-sample buckets, W = 64, with its design, device ms per
           stage, scratch bytes and exp floor, also against fused_mhsa with
           the same band at S = 772, the crossover witness, whose stages are
           taken too; both kernels timed with that band at S = 516 and 644);
           fused_ftf_bwd at the B=64 x
           2 s training shapes (all 15 gradients, relative to each one's
           largest magnitude; its lines also carry the design, the device
           ms of each stage, from one torch.profiler pass, and the bytes of
           scratch one launch allocates, read from the caching allocator's
           peak), and the
           save-hidden forward under grad
  enhance  the committed demo weights through load_enhancer + make_enhance:
           B=128 x 2 s (3 FTF launches, 0 MHSA; matches the plain path run
           on the CPU) and one bucketed batch of 163,840 samples with
           lengths (2 FTF launches, 1 MHSA; rows match the CPU plain path)
  banded   the same weights with max_time_context=64, bucketed batches with
           lengths: 196,608 samples x 20 and 917,504 x 4 (2 FTF, 0 MHSA,
           1 banded launches each) and 163,840 x 25 (2 FTF, 1 MHSA, 0
           banded); rows match the CPU plain path
  stream   StreamingEnhancer(max_time_context=64, 4 s chunks, 0.5 s
           overlap): a 20 s wave (one call of 8 chunk rows, 3 FTF launches)
           matches the CPU; a 60 s wave's real-time factor

  train    the GAN train step (full-width G from the demo weights, seeded
           MPD and MSD, TrainConfig() defaults) on seeded 2 s batches: launch
           counts per step (3 FTF forward, 3 FTF backward, 0 MHSA, 0
           banded), 5 steps at B=8 (finite metrics, all three parameter sets
           move), two runs from one state bit-equal, the card against the
           CPU plain step at B=2 (precise: losses, per-tensor gradient
           correlation), step time at B=8 and B=64 split into enhancer
           forward, D step, G step and the FTF backward kernels
  eval     make_eval_step on one bucketed batch with lengths, against the CPU
  loop     the training run end to end (train/loop.py::run_training at
           TrainConfig() defaults, 2 epochs, validation and checkpoints
           every epoch, STOI on) on a seeded synthetic corpus (32 train
           utterances of 2.5 s; 6 test ones of 1.5-9.0 s, two of them long
           enough for the composed time block and fused_mhsa): launch
           counts (FTF backward 3 per step, FTF forward in training and
           validation, MHSA in validation), a run of 1 epoch resumed from
           its last.pt to 2 bit-equal to the uninterrupted run (all three
           models and both optimizers), best.pt served by the infer CLI;
           a torch.profiler trace of epoch 1's steps 3-4 (profile_steps);
           the in-loop step ms against the train phase's bare B=8 step,
           audio-sec/s and validation seconds per epoch, and the device-idle
           share of the resumed run's epoch-2 training from a torch.profiler
           pass
  export   the export path with the reference-format demo weights:
           keep_kernels artifacts traced on the card at (128, 32000) and
           (4, 163840) (3/0/0 and 2/1/0 FTF/MHSA/banded launches per call,
           counted from the loaded program) and, with max_time_context=64,
           at (4, 196608) (2/0/1), each against make_enhance on the same
           input; the first also in a fresh process that imports the
           package, and timed against make_enhance (the ops' dispatch
           cost); a portable artifact traced on the CPU at (8, 32000): 0
           launches and no host copy per call on the card, equal to the CPU
           plain path, and loaded in a fresh process that imports torch
           alone; export and load seconds. Then export_cli (4 x 4 s, its
           artifact enhancing the loop phase's corpus in chunks) and
           metrics_cli on the result, ModelComparator with
           make_torch_system on one utterance (PNGs where matplotlib is
           installed), and bench_serving_latency's rows, one line each

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


def stage_of(kernel_name):
    """A profiler kernel name as a stage: the function's name with its
    template arguments, without namespaces, return type or parameters;
    the weight-gradient kernels and the reduction of their partials count
    as one stage, "wgrad"."""
    import re

    name = kernel_name.split("(", 1)[0]
    name = re.sub(r"^void\s+", "", name.strip())
    name = re.sub(r"\b\w+::", "", name)
    return "wgrad" if name.startswith(("wgrad", "reduce")) else name


def stages_ms(torch, fn, reps=3):
    """Device ms per call of each stage of `fn` (one torch.profiler pass
    over `reps` calls after one warm-up), largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            key = stage_of(evt.key)
            out[key] = out.get(key, 0.0) + us / reps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def scratch_bytes(torch, fn):
    """Device bytes one call of `fn` allocates beyond what it returns,
    measured: the caching allocator's peak of allocated bytes during the
    call, less the bytes still allocated after it with its result held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    nbytes = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del result
    return nbytes


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


def library_banded_ms(torch, N, L, lookback, mode):
    """`library_attention_ms` with the band mask, forced onto the
    memory-efficient backend. Returns (ms, None) or (None, reason)."""
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return library_attention_ms(torch, N, L, lookback, None,
                                        mode), None
    except (ImportError, RuntimeError) as exc:  # unsupported or out of
        torch.cuda.empty_cache()                # memory: record why
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


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


def library_mha_ms(torch, x, params, key_bias, mode):
    """The whole MHSA function in one PyTorch call:
    `multi_head_attention_forward` with the same weights and key padding
    mask (a yardstick only: the port never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    in_w, in_b, out_w, out_b = (p.to(dt) for p in params)
    q = x.to(dt).transpose(0, 1)            # [L, N, E]
    pad = key_bias != 0                     # True: masked key

    def call():
        return F.multi_head_attention_forward(
            q, q, q, 64, 4, in_w.t(), in_b, None, None, False, 0.0,
            out_w.t(), out_b, training=False, key_padding_mask=pad,
            need_weights=False)[0]

    ms = cuda_ms(torch, call, 3)
    del q, pad
    return ms


def check_kernels(torch, enhancer):
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)
    from lct_gan_tpu_torch.ops.gru import grouped_gru
    from lct_gan_tpu_torch.ops.probe import ex2_rate

    # With head_dim 16 the attention's exps, not its products, set the floor
    # of a kernel that computes them all: its exp count over the rate of the
    # special-function units, measured here with the kernels' instruction.
    exps_per_s = ex2_rate()
    emit({"phase": "kernels", "probe": "ex2.approx.ftz.f32 rate",
          "exps_per_s": exps_per_s})

    def exp_floor_ms(n_exps):
        return n_exps / exps_per_s * 1e3

    gen = enhancer.gen
    g = torch.Generator(device="cuda").manual_seed(1234)

    def masked_tail(N, L, n_valid_min):
        valid = torch.randint(n_valid_min, L + 1, (N,), generator=g,
                              device="cuda")
        pos = torch.arange(L, device="cuda")
        return torch.where(pos[None, :] < valid[:, None], 0.0,
                           -1e30).to(torch.float32)

    results = {"fused_ftf_block": [], "fused_mhsa": [], "banded_mhsa": []}
    ftf_cases = [
        # name, block, N, L, key_bias?, lookback  (B=128 x 2 s shapes)
        ("freq", gen.GRUf1, 128 * 129, 33, False, None),
        ("time_keybias", gen.GRUt1, 128 * 33, 129, True, None),
        ("time_lookback16", gen.GRUt1, 128 * 33, 129, False, 16),
    ]
    for name, block, N, L, use_kb, lookback in ftf_cases:
        params = [p.detach().contiguous() for p in block.kernel_params()]
        check_saved_hidden(torch, name, params, N, L, lookback, g)
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kb = masked_tail(N, L, L - 40) if use_kb else None
        rows = N * L
        lin_in = params[12].shape[0]
        flops = rows * (2 * 2 * D * 192 * 16 + 2 * 64 * 192 + 2 * 64 * 64
                        + 2 * lin_in * 64) + N * 4 * band_pairs(L, lookback) * 64
        extra = sum(p.numel() for p in params) * 4 + (rows * 4 if use_kb else 0)
        # One exp per in-band pair (the max pass needs none) and three per
        # GRU gate triple (two sigmoids, one tanh).
        exps = N * 4 * band_pairs(L, lookback) + rows * D * 64 * 3
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=D == 2, num_heads=4, lookback=lookback,
                      key_bias=kb, precise=mode == "precise")
            out = fused_ftf_block(x, *params, **kw)
            torch.cuda.synchronize()
            design = fused_ftf_block.design
            ref = ftf_block_reference(x, *params, **kw)
            err = (out - ref).abs().max().item()
            if not (err <= TOL[mode]) or not torch.isfinite(out).all():
                raise AssertionError(f"fused_ftf_block {name} {mode}: "
                                     f"max|diff| {err} > {TOL[mode]}")
            ms = cuda_ms(torch, lambda: fused_ftf_block(x, *params, **kw), 5)
            plain_ms = cuda_ms(
                torch, lambda: ftf_block_reference(x, *params, **kw), 2)
            bms, by = bound(rows, flops, extra, mode)
            res = {"case": name, "mode": mode, "design": design, "N": N,
                   "L": L, "max_abs_err": err, "tol": TOL[mode], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "exp_floor_ms": exp_floor_ms(exps),
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
        exps = 2 * N * 4 * L * L   # two per pair: the max and sum, then p
        for mode in ("bf16", "precise"):
            kw = dict(num_heads=4, key_bias=kb, precise=mode == "precise")
            out = fused_mhsa(x, *aparams, **kw)
            torch.cuda.synchronize()
            design = fused_mhsa.design
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
            res = {"case": f"L{L}_keybias", "mode": mode, "design": design,
                   "N": N, "L": L, "max_abs_err": err, "tol": TOL[mode],
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "exp_floor_ms": exp_floor_ms(exps),
                   "library_ms": library_attention_ms(torch, N, L, None, kb,
                                                      mode),
                   "library_mha_ms": library_mha_ms(torch, x, aparams, kb,
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

    # Banded time blocks (W = 64) of the 196,608- and 917,504-sample buckets
    # (adaptive rows 20 and 4; bottleneck S = 772 and 3,588). The key-masked
    # tails reach past W + 1 frames, so some rows' whole band is masked.
    W = 64
    for B, S in ((20, 772), (4, 3588)):
        N = B * 33
        x = torch.randn((N, S, 64), generator=g, device="cuda")
        kb = masked_tail(N, S, S - 200)
        rows = N * S
        flops = (rows * (2 * 64 * 192 + 2 * 64 * 64)
                 + N * 4 * band_pairs(S, W) * 64)
        extra = sum(p.numel() for p in aparams) * 4 + rows * 4
        for mode in ("bf16", "precise"):
            kw = dict(num_heads=4, lookback=W, key_bias=kb,
                      precise=mode == "precise")
            out = banded_mhsa(x, *aparams, **kw)
            torch.cuda.synchronize()
            design = banded_mhsa.design
            ref = banded_mhsa_reference(x, *aparams, **kw)
            err = (out - ref).abs().max().item()
            if not (err <= TOL[mode]) or not torch.isfinite(out).all():
                raise AssertionError(f"banded_mhsa S={S} {mode}: max|diff| "
                                     f"{err} > {TOL[mode]}")
            del ref
            torch.cuda.empty_cache()
            res = {"case": f"S{S}_W{W}_keybias", "mode": mode,
                   "design": design, "N": N, "L": S, "max_abs_err": err,
                   "tol": TOL[mode],
                   "scratch_bytes": scratch_bytes(
                       torch, lambda: banded_mhsa(x, *aparams, **kw))}
            if S <= 1024:
                # Crossover witness: the MHSA kernel with the same band
                # computes the same function in O(S^2).
                mh = fused_mhsa(x, *aparams, **kw)
                torch.cuda.synchronize()
                xerr = (out - mh).abs().max().item()
                if not xerr <= TOL[mode]:
                    raise AssertionError(f"banded_mhsa vs fused_mhsa S={S} "
                                         f"{mode}: {xerr} > {TOL[mode]}")
                del mh
                res["vs_fused_mhsa_max_abs_err"] = xerr
                res["fused_mhsa_ms"] = cuda_ms(
                    torch, lambda: fused_mhsa(x, *aparams, **kw), 3)
                res["fused_mhsa_stages_ms"] = stages_ms(
                    torch, lambda: fused_mhsa(x, *aparams, **kw))
            del out
            res["ms"] = cuda_ms(torch, lambda: banded_mhsa(x, *aparams, **kw),
                                5)
            res["stages_ms"] = stages_ms(
                torch, lambda: banded_mhsa(x, *aparams, **kw))
            # One exp per in-band pair: the least a kernel that takes the
            # exact max before it rounds p can spend on the special-function
            # unit.
            res["exp_floor_ms"] = exp_floor_ms(N * 4 * band_pairs(S, W))
            res["plain_ms"] = cuda_ms(
                torch, lambda: banded_mhsa_reference(x, *aparams, **kw), 2)
            torch.cuda.empty_cache()
            res["bound_ms"], res["bound_by"] = bound(rows, flops, extra, mode)
            res["library_ms"], why = library_banded_ms(torch, N, S, W, mode)
            if why:
                res["library_unavailable"] = why
            res["flops"] = flops
            results["banded_mhsa"].append(res)
            emit({"phase": "kernels", "kernel": "banded_mhsa", **res})
        del x, kb
        torch.cuda.empty_cache()

    # Crossover below BANDED_KERNEL_MIN_SEQ (769): the band served by either
    # kernel at the composed time blocks of the 131,072- and 163,840-sample
    # buckets (timing only; the path keeps the MHSA kernel there).
    for B, S in ((31, 516), (25, 644)):
        N = B * 33
        x = torch.randn((N, S, 64), generator=g, device="cuda")
        kb = masked_tail(N, S, S - 130)
        kw = dict(num_heads=4, lookback=W, key_bias=kb)
        emit({"phase": "kernels", "crossover": "W=64 bf16", "N": N, "L": S,
              "banded_mhsa_ms": cuda_ms(
                  torch, lambda: banded_mhsa(x, *aparams, **kw), 5),
              "fused_mhsa_ms": cuda_ms(
                  torch, lambda: fused_mhsa(x, *aparams, **kw), 5)})
        del x, kb
    torch.cuda.empty_cache()
    results["fused_ftf_bwd"] = check_ftf_bwd(torch, gen, g, exp_floor_ms)
    return results


def check_saved_hidden(torch, name, params, N, L, lookback, g):
    """Under grad the FTF forward keeps the hiddens its kernels write: its
    output is bit-equal to the no-grad forward's, and the hiddens match the
    plain forward's."""
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           ftf_forward_with_hidden,
                                           fused_ftf_block)

    D = 2 if params[12].shape[0] == 128 else 1
    x = torch.randn((N, L, 64), generator=g, device="cuda")
    for mode in ("bf16", "precise"):
        kw = dict(bidirectional=D == 2, num_heads=4, lookback=lookback,
                  precise=mode == "precise")
        with torch.no_grad():
            plain_out = fused_ftf_block(x, *params, **kw)
        leaves = [t.detach().clone().requires_grad_() for t in [x] + params]
        out = fused_ftf_block(*leaves, **kw)
        if not torch.equal(out.detach(), plain_out):
            raise AssertionError(f"save-hidden forward {name} {mode}: output "
                                 "differs from the no-grad forward")
        del out, leaves
        _, hid = ftf_forward_with_hidden(x, *params, **kw)
        _, ref_hid = ftf_block_reference(x, *params, return_hidden=True,
                                         **kw)
        err = (hid - ref_hid).abs().max().item()
        if not err <= TOL[mode]:
            raise AssertionError(f"saved hid {name} {mode}: max|diff| {err} "
                                 f"> {TOL[mode]}")
        emit({"phase": "kernels", "check": "save-hidden forward",
              "case": name, "mode": mode, "output_bit_equal": True,
              "hid_max_abs_err": err, "tol": TOL[mode]})
        del hid, ref_hid
    del x
    torch.cuda.empty_cache()


def library_attention_bwd_ms(torch, N, L, lookback, mode):
    """One scaled_dot_product_attention forward + backward on the same
    [N, 4, L, 16] attention (a yardstick only: the port never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((N, 4, L, 16), generator=g, device="cuda",
                               dtype=dt) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = None
    if lookback is not None:
        pos = torch.arange(L, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] >= pos[:, None] - lookback))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        torch.autograd.grad(out, (q, k, v), do)

    ms = cuda_ms(torch, fwd_bwd, 5)
    del q, k, v, do, mask
    return ms


def ftf_bwd_flops(N, L, D, lin_in, lookback):
    """Useful products of the FTF backward: the forward products it
    recomputes (qkv, out-proj, Linear, GRU input and hidden projections,
    attention scores and context) plus two products per GEMM for the
    gradients, and four per attention pair (dp, dq, dk, dv)."""
    rows = N * L
    gemm = 2 * 64 * 192 + 2 * 64 * 64 + 2 * lin_in * 64
    gru = D * 2 * (2 * 64 * 48)          # grouped W_ih and W_hh per direction
    return rows * 3 * (gemm + gru) + N * 4 * band_pairs(L, lookback) * 6 * 32


def check_ftf_bwd(torch, gen, g, exp_floor_ms):
    """fused_ftf_bwd against ftf_bwd_reference at the training shapes of
    B=64 x 2 s, all 15 outputs, both modes; each case's design, device ms
    per stage (stages_ms), scratch bytes and exp floor."""
    from lct_gan_tpu_torch.ops.ftf import ftf_forward_with_hidden
    from lct_gan_tpu_torch.ops.ftf_bwd import (ftf_bwd_reference,
                                               fused_ftf_bwd)

    names = ("dx", "dln1s", "dln1b", "dw_ih", "dw_hh", "db_ih", "db_hh",
             "dln2s", "dln2b", "din_w", "din_b", "dout_w", "dout_b",
             "dlin_w", "dlin_b")
    results = []
    for name, block, N, L, lookback in (
            ("freq", gen.GRUf1, 64 * 129, 33, None),
            ("time", gen.GRUt1, 64 * 33, 129, None),
            ("time_lookback16", gen.GRUt1, 64 * 33, 129, 16)):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        lin_in = params[12].shape[0]
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        rows = N * L
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=D == 2, num_heads=4, lookback=lookback,
                      precise=mode == "precise")
            out, hid = ftf_forward_with_hidden(x, *params, **kw)
            # The LeakyReLU's derivative jumps at comb = 0, and two sum
            # orders put a comb within rounding noise of 0 on different
            # sides (a 0.8 * dout jump in that element's gradient). The
            # cotangent is zeroed within `eps` of the kink, so both
            # versions compute the same smooth function of their inputs.
            act = out - x - hid.sum(dim=0).reshape(N, L, 64)
            comb = torch.where(act >= 0, act, act / 0.2)
            eps = 5e-2 if mode == "bf16" else 1e-3
            dout = torch.randn((N, L, 64), generator=g, device="cuda")
            dout = torch.where(comb.abs() < eps, 0.0, dout)
            del out, act, comb
            got = fused_ftf_bwd(x, *params, hid, dout, **kw)
            torch.cuda.synchronize()
            design = fused_ftf_bwd.design
            want = ftf_bwd_reference(x, *params, hid, dout, **kw)
            rel = {n: ((a - b).abs().max() / b.abs().max()).item()
                   for n, a, b in zip(names, got, want)}
            abs_err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
            bad = {n: e for n, e in rel.items() if not e <= TOL[mode]}
            if bad or not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"fused_ftf_bwd {name} {mode}: relative "
                                     f"errors over {TOL[mode]}: {bad}")
            del got, want
            torch.cuda.empty_cache()
            ms = cuda_ms(torch, lambda: fused_ftf_bwd(x, *params, hid, dout,
                                                      **kw), 3)
            stages = stages_ms(torch, lambda: fused_ftf_bwd(
                x, *params, hid, dout, **kw))
            plain_ms = cuda_ms(torch, lambda: ftf_bwd_reference(
                x, *params, hid, dout, **kw), 1)
            torch.cuda.empty_cache()
            flops = ftf_bwd_flops(N, L, D, lin_in, lookback)
            nbytes = (rows * 64 * 4 * (2 + D)          # x, dout, hid
                      + rows * 64 * 4                  # dx
                      + 2 * sum(p.numel() for p in params) * 4)
            t_bytes = nbytes / H100_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[mode]
            # One exp per in-band attention pair and three per GRU unit per
            # row per direction (two sigmoids, one tanh).
            exps = N * 4 * band_pairs(L, lookback) + rows * D * 64 * 3
            res = {"case": name, "mode": mode, "design": design, "N": N,
                   "L": L, "max_abs_err": abs_err,
                   "max_rel_err": max(rel.values()),
                   "rel_err": rel, "tol": TOL[mode],
                   "masked_share": (dout == 0).float().mean().item(),
                   "ms": ms, "stages_ms": stages,
                   "scratch_bytes": scratch_bytes(
                       torch, lambda: fused_ftf_bwd(x, *params, hid, dout,
                                                    **kw)),
                   "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "exp_floor_ms": exp_floor_ms(exps),
                   "library_ms": library_attention_bwd_ms(torch, N, L,
                                                          lookback, mode),
                   "flops": flops}
            results.append(res)
            emit({"phase": "kernels", "kernel": "fused_ftf_bwd", **res})
            del hid, dout
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
    return results


def run_counted(torch, enhance, x, lengths, expect):
    """One main-path call with every launch count set to 0 just before and
    read just after; raises unless the counts are `expect`."""
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

    fused_ftf_block.launches = 0
    fused_mhsa.launches = 0
    banded_mhsa.launches = 0
    fused_ftf_bwd.launches = 0
    out = enhance(x) if lengths is None else enhance(x, lengths)
    torch.cuda.synchronize()
    got = {"fused_ftf_block": fused_ftf_block.launches,
           "fused_mhsa": fused_mhsa.launches,
           "banded_mhsa": banded_mhsa.launches,
           "fused_ftf_bwd": fused_ftf_bwd.launches}
    expect = {"fused_ftf_bwd": 0, **expect}
    if got != expect:
        raise AssertionError(f"launch counts {got}, expected {expect}")
    return out, got


def check_enhance(torch, np, card, enhancer):
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import bucket_length
    from lct_gan_tpu_torch.eval import make_enhance

    cpu_enhancer = load_enhancer(CHECKPOINT, device="cpu")
    enhance = make_enhance(enhancer)
    launches = {"fused_ftf_block": 0, "fused_mhsa": 0, "banded_mhsa": 0,
                "fused_ftf_bwd": 0}
    rng = np.random.default_rng(1)

    # Workload 1: B=128 x 2 s seeded noise (the fixed bench workload).
    wave = (0.1 * rng.standard_normal((128, 2 * SR))).astype(np.float32)
    x = torch.from_numpy(wave).cuda()
    enhance(x)  # warm-up
    out, got = run_counted(torch, enhance, x, None,
                           {"fused_ftf_block": 3, "fused_mhsa": 0,
                            "banded_mhsa": 0})
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
                           {"fused_ftf_block": 2, "fused_mhsa": 1,
                            "banded_mhsa": 0})
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


def bucket_batch(np, rng, T, B):
    """B seeded noise rows of the T-sample bucket with lengths in
    (7/8 T, T], zero-padded: (wave [B, T] f32, lengths [B] int64)."""
    from lct_gan_tpu_torch.data import bucket_length

    lens = rng.integers(T - T // 8 + 1, T + 1, size=B).astype(np.int64)
    if any(bucket_length(int(n)) != T for n in lens):
        raise AssertionError(f"lengths outside the {T}-sample bucket")
    wave = np.zeros((B, T), np.float32)
    for r, n in enumerate(lens):
        wave[r, :n] = 0.1 * rng.standard_normal(n)
    return wave, lens


def check_banded(torch, np, card):
    """The banded-causal serving configuration (max_time_context = 64)."""
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.ops.gru import grouped_gru

    enhancer = load_enhancer(CHECKPOINT, device="cuda", max_time_context=64)
    gru = [p.detach() for p in enhancer.gen.GRUt1.kernel_params()[2:6]]
    cpu_enhancer = load_enhancer(CHECKPOINT, device="cpu",
                                 max_time_context=64)
    enhance = make_enhance(enhancer)
    launches = {"fused_ftf_block": 0, "fused_mhsa": 0, "banded_mhsa": 0}
    rng = np.random.default_rng(2)
    for T, rows_checked, expect in (
            (196608, 2, (2, 0, 1)),
            (917504, 1, (2, 0, 1)),
            # routing boundary: S = 644 < 769 stays on the MHSA kernel
            (163840, 1, (2, 1, 0))):
        B = 128 * 32000 // T
        wave, lens = bucket_batch(np, rng, T, B)
        x = torch.from_numpy(wave).cuda()
        ln = torch.from_numpy(lens).cuda()
        enhance(x, ln)  # warm-up
        out, got = run_counted(torch, enhance, x, ln, dict(zip(
            ("fused_ftf_block", "fused_mhsa", "banded_mhsa"), expect)))
        for k in launches:
            launches[k] += got[k]
        if not torch.isfinite(out).all() or tuple(out.shape) != (B, T):
            raise AssertionError(f"banded output bad: {tuple(out.shape)}")
        r = rows_checked
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref_wave, _ = cpu_enhancer(torch.from_numpy(wave[:r]),
                                       torch.from_numpy(lens[:r]))
            cpu_s = time.perf_counter() - t0
        werr = (out[:r].cpu() - ref_wave).abs().max().item()
        if not werr <= TOL_WAVE:
            raise AssertionError(f"banded B={B} x {T}: rows vs CPU plain "
                                 f"path {werr} > {TOL_WAVE}")
        ms = cuda_ms(torch, lambda: enhance(x, ln), 2)
        # The composed time block's GRU loop (plain torch, launch-bound on
        # the host) alone, at this call's time-block shape, under the same
        # inference mode as the call.
        S = T // 256 + 4
        h = torch.randn((B * 33, S, 64), device="cuda")
        with torch.inference_mode():
            gru_ms = cuda_ms(torch, lambda: grouped_gru(
                h, *gru, bidirectional=False), 1)
        emit({"phase": "banded", "workload": f"bucketed B={B} x {T} samples",
              "max_time_context": 64, "launches": got,
              "rows_checked": r, "wave_max_abs_err_vs_cpu": werr,
              "tol_wave": TOL_WAVE, "cpu_plain_s": cpu_s, "ms_per_call": ms,
              "audio_sec_per_s": float(lens.sum()) / SR / (ms / 1e3),
              "time_block_S": S, "composed_gru_ms": gru_ms,
              "composed_gru_share": gru_ms / ms, "device": card})
        del x, ln, out, h
        torch.cuda.empty_cache()
    return launches


def check_stream(torch, np, card):
    """Chunked streaming with the banded configuration, card vs CPU."""
    from lct_gan_tpu_torch.eval import StreamingEnhancer

    kw = dict(max_time_context=64, chunk_seconds=4.0, overlap_seconds=0.5)
    se = StreamingEnhancer(CHECKPOINT, **kw)
    se_cpu = StreamingEnhancer(CHECKPOINT, device="cpu", **kw)
    rng = np.random.default_rng(3)
    wave = (0.1 * rng.standard_normal(20 * SR)).astype(np.float32)
    se(wave)  # warm-up
    out, got = run_counted(torch, se, wave, None, {
        "fused_ftf_block": 3, "fused_mhsa": 0, "banded_mhsa": 0})
    ref = se_cpu(wave)
    err = float(np.abs(out - ref).max())
    if out.shape != wave.shape or not np.isfinite(out).all() \
            or not err <= TOL_WAVE:
        raise AssertionError(f"stream 20 s vs CPU: {err} (tol {TOL_WAVE}), "
                             f"shape {out.shape}")
    long_wave = (0.1 * rng.standard_normal(60 * SR)).astype(np.float32)
    se(long_wave)  # warm-up (one call of 32 chunk rows)
    t0 = time.perf_counter()
    out = se(long_wave)
    wall = time.perf_counter() - t0
    if out.shape != long_wave.shape or not np.isfinite(out).all():
        raise AssertionError("stream 60 s output bad")
    emit({"phase": "stream", "chunk_seconds": 4.0, "overlap_seconds": 0.5,
          "max_time_context": 64, "launches_20s": got,
          "wave_max_abs_err_vs_cpu_20s": err, "tol_wave": TOL_WAVE,
          "wall_s_60s": wall, "real_time_factor_60s": 60.0 / wall,
          "device": card})
    return got


TOL_LOSS = 1e-4       # card vs CPU step, precise, relative
MIN_GRAD_CORR = 0.999  # card vs CPU gradients, per tensor


def train_batch(np, rng, B):
    """Seeded noisy / clean 2 s batches, the JAX package's test recipe."""
    clean = (0.1 * rng.standard_normal((B, 2 * SR))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal((B, 2 * SR))).astype(
        np.float32)
    return noisy, clean


def step_grads(torch, cfg, state, noisy, clean):
    """D and G gradients of one step's losses at the state's parameters,
    through the step's own loss functions (the G loss against this D)."""
    from lct_gan_tpu_torch.sigproc.features import (TFFeaturesConfig,
                                                    compute_tf_features)
    from lct_gan_tpu_torch.train import (discriminator_step_loss,
                                         generator_step_loss)

    dev = next(state.enhancer.parameters()).device
    noisy = torch.from_numpy(noisy).to(dev)
    clean = torch.from_numpy(clean).to(dev)
    with torch.no_grad():
        irm_c = compute_tf_features(noisy, clean, TFFeaturesConfig(
            c=cfg.compress_c, return_stfts=False))["irm_c"]
    enhanced, mask_c = state.enhancer(noisy)
    d_loss = discriminator_step_loss(cfg, state.mpd, state.msd, clean,
                                     enhanced.detach())
    d_grads = torch.autograd.grad(d_loss, state.d_params())
    g_loss, _ = generator_step_loss(cfg, state.mpd, state.msd, enhanced,
                                    mask_c, irm_c, clean)
    g_grads = torch.autograd.grad(g_loss, state.g_params())
    return [t.cpu() for t in d_grads], [t.cpu() for t in g_grads]


def timed_steps(torch, cfg, state, np, rng, B, n_warm=2, n_timed=5):
    """Median step ms over n_timed steps after n_warm, split by the step's
    phases (CUDA events at its marks)."""
    import statistics

    from lct_gan_tpu_torch.train import make_train_step

    step = make_train_step(cfg)
    noisy, clean = train_batch(np, rng, B)
    noisy, clean = torch.from_numpy(noisy).cuda(), torch.from_numpy(
        clean).cuda()
    for _ in range(n_warm):
        step(state, noisy, clean)
    torch.cuda.synchronize()
    rows = []
    for _ in range(n_timed):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((phase, ev))

        t0 = time.perf_counter()
        metrics = step(state, noisy, clean, mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        row = {"wall_ms": wall}
        for (_, a), (phase, b) in zip(events, events[1:]):
            row[f"{phase}_ms"] = a.elapsed_time(b)
        rows.append(row)
        for k, v in metrics.items():
            if not torch.isfinite(v):
                raise AssertionError(f"train B={B}: {k} not finite")
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def ftf_bwd_step_ms(torch, state, B):
    """The three FTF backward launches of one step at batch B, timed alone
    (the CUDA events cannot isolate them inside autograd)."""
    from lct_gan_tpu_torch.ops.ftf import ftf_forward_with_hidden
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

    gen = state.enhancer.gen
    g = torch.Generator(device="cuda").manual_seed(5)
    total = 0.0
    for block, N, L in ((gen.GRUf1, B * 129, 33), (gen.GRUt1, B * 33, 129),
                        (gen.GRUf2, B * 129, 33)):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        kw = dict(bidirectional=block.bidirectional, num_heads=4,
                  lookback=None, precise=False)
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        dout = torch.randn((N, L, 64), generator=g, device="cuda")
        _, hid = ftf_forward_with_hidden(x, *params, **kw)
        total += cuda_ms(torch, lambda: fused_ftf_bwd(x, *params, hid, dout,
                                                      **kw), 3)
        del x, dout, hid
    return total


def corr(a, b):
    """Correlation of two gradient tensors; a one-element tensor counts as
    correlated when it agrees to 1e-3 relative."""
    a, b = a.double().flatten(), b.double().flatten()
    if a.numel() < 2:
        return float(abs(float(a - b)) <= 1e-3 * abs(float(b)) + 1e-12)
    a, b = a - a.mean(), b - b.mean()
    den = float(a.norm() * b.norm())
    if den == 0.0:
        return float(float(a.norm()) == float(b.norm()))
    return float(a @ b) / den


def check_train(torch, np, card):
    """The GAN train step at full width on the card."""
    import copy

    from lct_gan_tpu_torch.convert import read_npz_params
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
    from lct_gan_tpu_torch.train import (TrainConfig, create_state,
                                         make_train_step)

    cfg = TrainConfig()
    g_params, _ = read_npz_params(CHECKPOINT)

    def fresh(device, precise=False):
        return create_state(cfg, torch.Generator().manual_seed(0),
                            device=device, precise=precise,
                            g_params=g_params)

    state0 = fresh("cuda")
    counts = {"enhancer": sum(p.numel() for p in state0.g_params()),
              "mpd": sum(p.numel() for p in state0.mpd.parameters()),
              "msd": sum(p.numel() for p in state0.msd.parameters())}
    if counts != {"enhancer": 135425, "mpd": 785770, "msd": 16924086}:
        raise AssertionError(f"parameter counts {counts}")
    step = make_train_step(cfg)
    rng = np.random.default_rng(7)
    noisy, clean = train_batch(np, rng, cfg.batch_size)

    # Two runs from one state, one batch: bit-equal metrics and parameters.
    a, b = copy.deepcopy(state0), copy.deepcopy(state0)
    ma, mb = step(a, noisy, clean), step(b, noisy, clean)
    same = all(torch.equal(ma[k], mb[k]) for k in ma) and all(
        torch.equal(p, q) for p, q in zip(
            [*a.g_params(), *a.d_params()], [*b.g_params(), *b.d_params()]))
    if not same:
        raise AssertionError("two train steps from one state differ")
    del a, b

    # The counted run: one step of the main path.
    state = copy.deepcopy(state0)
    for fn in (fused_ftf_block, fused_ftf_bwd, fused_mhsa, banded_mhsa):
        fn.launches = 0
    step(state, noisy, clean)
    torch.cuda.synchronize()
    got = {"fused_ftf_block": fused_ftf_block.launches,
           "fused_ftf_bwd": fused_ftf_bwd.launches,
           "fused_mhsa": fused_mhsa.launches,
           "banded_mhsa": banded_mhsa.launches}
    expect = {"fused_ftf_block": 3, "fused_ftf_bwd": 3, "fused_mhsa": 0,
              "banded_mhsa": 0}
    if got != expect:
        raise AssertionError(f"train step launches {got}, expected {expect}")

    # Four more steps (five in all): finite metrics, every set moves.
    history = []
    for _ in range(4):
        noisy_i, clean_i = train_batch(np, rng, cfg.batch_size)
        m = step(state, noisy_i, clean_i)
        history.append({k: float(v) for k, v in m.items()})
        if not all(np.isfinite(v) for v in history[-1].values()):
            raise AssertionError(f"train metrics not finite: {history[-1]}")
    moved = {}
    for part, old, new in (
            ("g", state0.g_params(), state.g_params()),
            ("mpd", list(state0.mpd.parameters()),
             list(state.mpd.parameters())),
            ("msd", list(state0.msd.parameters()),
             list(state.msd.parameters()))):
        moved[part] = max((p - q).abs().max().item()
                          for p, q in zip(old, new))
        if not moved[part] > 0:
            raise AssertionError(f"{part} parameters did not move")
    emit({"phase": "train", "check": "B=8 x 2 s, 5 steps",
          "parameter_counts": counts, "launches_per_step": got,
          "two_runs_bit_equal": True, "metrics_steps_2_5": history,
          "max_param_move": moved, "device": card})
    del state

    # The card against the CPU plain step, precise, B=2 x 2 s.
    noisy2, clean2 = train_batch(np, np.random.default_rng(8), 2)
    card_s, cpu_s = fresh("cuda", True), fresh("cpu", True)
    d_card, g_card = step_grads(torch, cfg, card_s, noisy2, clean2)
    t0 = time.perf_counter()
    d_cpu, g_cpu = step_grads(torch, cfg, cpu_s, noisy2, clean2)
    grad_cpu_s = time.perf_counter() - t0
    corrs = [corr(x, y) for x, y in zip(d_card + g_card, d_cpu + g_cpu)]
    if not min(corrs) > MIN_GRAD_CORR:
        raise AssertionError(f"card vs CPU gradients: min correlation "
                             f"{min(corrs)} <= {MIN_GRAD_CORR}")
    m_card = {k: float(v) for k, v in step(card_s, noisy2, clean2).items()}
    m_cpu = {k: float(v) for k, v in step(cpu_s, noisy2, clean2).items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    if not max(rel.values()) <= TOL_LOSS:
        raise AssertionError(f"card vs CPU step losses: {rel} > {TOL_LOSS}")
    emit({"phase": "train", "check": "card vs CPU plain step, precise, "
          "B=2 x 2 s", "loss_rel_err": rel, "tol_loss": TOL_LOSS,
          "min_grad_corr": min(corrs), "grad_tensors": len(corrs),
          "min_corr_tol": MIN_GRAD_CORR, "cpu_grads_s": grad_cpu_s,
          "metrics_card": m_card})
    del card_s, cpu_s
    torch.cuda.empty_cache()

    step_ms = {}
    for B in (8, 64):
        state = copy.deepcopy(state0)
        torch.cuda.reset_peak_memory_stats()
        t = timed_steps(torch, cfg, state, np, rng, B)
        t["ftf_bwd_ms"] = ftf_bwd_step_ms(torch, state, B)
        t["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        emit({"phase": "train", "check": f"step time B={B} x 2 s "
              "(median of 5 after 2 warm-up)", **t,
              "audio_sec_per_s": B * 2.0 / (t["wall_ms"] / 1e3),
              "device": card})
        step_ms[B] = t["wall_ms"]
        del state
        torch.cuda.empty_cache()
    return got, state0, step_ms


def check_eval(torch, np, card, state):
    """make_eval_step on one bucketed batch with lengths, card vs CPU."""
    import copy

    from lct_gan_tpu_torch.train import TrainConfig, make_eval_step

    eval_step = make_eval_step(TrainConfig())
    rng = np.random.default_rng(9)
    wave, lens = bucket_batch(np, rng, 65536, 6)
    clean = (0.8 * wave).astype(np.float32)
    enh, m = eval_step(state.enhancer, wave, clean, lens)
    cpu_enhancer = copy.deepcopy(state.enhancer).cpu()
    enh_cpu, m_cpu = eval_step(cpu_enhancer, wave, clean, lens)
    werr = (enh.cpu() - enh_cpu).abs().max().item()
    mr_rel = ((m["mrstft"].cpu() - m_cpu["mrstft"]).abs()
              / m_cpu["mrstft"].abs()).max().item()
    si_err = (m["si_sdr"].cpu() - m_cpu["si_sdr"]).abs().max().item()
    ok = (werr <= TOL_WAVE and mr_rel <= 1e-2 and si_err <= 0.1
          and torch.isfinite(m["si_sdr"]).all()
          and tuple(enh.shape) == wave.shape)
    if not ok:
        raise AssertionError(f"eval card vs CPU: wave {werr}, mrstft rel "
                             f"{mr_rel}, si_sdr {si_err}")
    emit({"phase": "eval", "batch": f"bucketed B=6 x 65536 with lengths",
          "wave_max_abs_err_vs_cpu": werr, "tol_wave": TOL_WAVE,
          "mrstft_max_rel_err_vs_cpu": mr_rel, "si_sdr_max_abs_err_db": si_err,
          "si_sdr_db": m["si_sdr"].tolist(), "device": card})


LOOP_TRAIN = 32                               # utterances of 2.5 s
LOOP_TEST_S = (1.5, 2.7, 4.0, 5.5, 7.0, 9.0)  # 7.0 and 9.0 s: L > 512


def write_corpus(np, root):
    """A seeded synthetic corpus in the repo's layout: root/{clean,noisy}_
    {train,test}/<id>.wav and root/{train,test}.scp. Clean: two gliding
    tones with a syllable-rate envelope; noisy: clean plus white noise at
    about 5 dB SNR."""
    from lct_gan_tpu_torch.data import write_wav

    rng = np.random.default_rng(21)
    for split, secs in (("train", (2.5,) * LOOP_TRAIN),
                        ("test", LOOP_TEST_S)):
        for sub in ("clean", "noisy"):
            os.makedirs(os.path.join(root, f"{sub}_{split}"))
        ids = []
        for i, sec in enumerate(secs):
            uid = f"{split}{i:03d}"
            t = np.arange(int(sec * SR)) / SR
            f0 = rng.uniform(120.0, 300.0)
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
            clean = env * (0.2 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * t))
                           + 0.1 * np.sin(2 * np.pi * 2.7 * f0 * t))
            noisy = clean + 0.05 * rng.standard_normal(t.size)
            write_wav(os.path.join(root, f"clean_{split}", f"{uid}.wav"),
                      clean.astype(np.float32), SR)
            write_wav(os.path.join(root, f"noisy_{split}", f"{uid}.wav"),
                      noisy.astype(np.float32), SR)
            ids.append(uid)
        with open(os.path.join(root, f"{split}.scp"), "w") as f:
            f.write("\n".join(ids) + "\n")


def same_payload(torch, a, b):
    """Two checkpoint payloads' models and optimizer states bit-equal."""
    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(eq, x, y))
        return x == y
    keys = ("enhancer", "mpd", "msd", "g_opt", "d_opt", "step", "epoch")
    return {k: eq(a[k], b[k]) for k in keys}


def idle_share(trace_path, span):
    """Device idleness inside the `span` annotation of a torch.profiler
    chrome trace, from the union of its kernel, memcpy and memset
    intervals: the idle share of the span, its length and busy ms, the idle
    ms before the first device activity (the wait for the first batch) and
    after the last, and the five longest gaps between."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = next(e for e in events if e.get("name") == span
               and e.get("cat") == "user_annotation")
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    busy = sorted((max(lo, float(e["ts"])),
                   min(hi, float(e["ts"]) + float(e.get("dur", 0))))
                  for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "ts" in e)
    merged = []
    for a, b in busy:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        raise AssertionError(f"no device activity inside {span}")
    total = sum(b - a for a, b in merged)
    gaps = sorted((b0 - a1) / 1e3 for (_, a1), (b0, _) in
                  zip(merged, merged[1:]))[::-1]
    return {"idle_share": 1.0 - total / (hi - lo),
            "span_ms": (hi - lo) / 1e3, "busy_ms": total / 1e3,
            "lead_idle_ms": (merged[0][0] - lo) / 1e3,
            "tail_idle_ms": (hi - merged[-1][1]) / 1e3,
            "longest_gaps_ms": gaps[:5]}


def check_loop(torch, np, card, bare_step_ms):
    """The training run end to end at TrainConfig() defaults: a 2-epoch
    run, a 1-epoch run resumed to 2 (bit-equal), best.pt served by the
    infer CLI."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from lct_gan_tpu_torch import infer
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import read_wav
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
    from lct_gan_tpu_torch.train import DataConfig, TrainConfig, run_training

    wrappers = (fused_ftf_block, fused_ftf_bwd, fused_mhsa, banded_mhsa)
    root = tempfile.mkdtemp(prefix="lct_loop_")
    try:
        data_root = os.path.join(root, "data")
        write_corpus(np, data_root)
        data = DataConfig(data_root=data_root)
        cfg = TrainConfig(epochs=2, val_interval=1, ckpt_interval=1)
        kw = dict(device="cuda", compute_pesq=False, compute_stoi=True)

        # The counted run: 2 epochs of the main path.
        for w in wrappers:
            w.launches = 0
        full = run_training(cfg, data, expr_root=os.path.join(root, "a"),
                            profile_steps=1, **kw)
        torch.cuda.synchronize()
        got = {w.__name__: w.launches for w in wrappers}
        steps = sum(e["steps"] for e in full["epochs"])
        per_epoch = LOOP_TRAIN // cfg.batch_size
        if [e["steps"] for e in full["epochs"]] != [per_epoch] * 2:
            raise AssertionError(f"steps per epoch {full['epochs']}")
        if not (got["fused_ftf_bwd"] == 3 * steps
                and got["fused_ftf_block"] > 3 * steps
                and got["fused_mhsa"] > 0 and got["banded_mhsa"] == 0):
            raise AssertionError(f"loop launches {got} for {steps} steps")
        ckpts = os.path.join(full["run_dir"], "ckpts")
        names = sorted(os.listdir(ckpts))
        if names != ["best.pt", "epoch_0001.pt", "epoch_0002.pt", "last.pt"]:
            raise AssertionError(f"checkpoints {names}")
        with open(os.path.join(full["run_dir"], "profile",
                               "trace.json")) as f:
            n_kernels = sum(e.get("cat") == "kernel"
                            for e in json.load(f)["traceEvents"])
        if n_kernels == 0:
            raise AssertionError("profile_steps traced no kernel")
        for name in ("configs.json", "metrics.csv"):
            if not os.path.isfile(os.path.join(full["run_dir"], name)):
                raise AssertionError(f"{name} missing")

        # 1 epoch, then resumed to 2 under a profiler: bit-equal.
        first = run_training(dataclasses.replace(cfg, epochs=1), data,
                             expr_root=os.path.join(root, "b"), **kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            resumed = run_training(
                cfg, data, resume=os.path.join(first["run_dir"], "ckpts",
                                               "last.pt"), **kw)
        trace = os.path.join(root, "trace.json")
        prof.export_chrome_trace(trace)
        idle = idle_share(trace, "train_epoch")
        if resumed["run_dir"] != first["run_dir"]:
            raise AssertionError("resume left its run directory")
        a = torch.load(os.path.join(ckpts, "last.pt"), map_location="cpu",
                       weights_only=True)
        b = torch.load(os.path.join(first["run_dir"], "ckpts", "last.pt"),
                       map_location="cpu", weights_only=True)
        same = same_payload(torch, a, b)
        if not all(same.values()):
            raise AssertionError(f"resumed run differs: {same}")
        del a, b

        # best.pt through load_enhancer and the infer CLI.
        best = os.path.join(ckpts, "best.pt")
        enh = load_enhancer(best, device="cuda")
        sd = torch.load(best, map_location="cpu",
                        weights_only=True)["enhancer"]
        if not all(torch.equal(v.cpu(), sd[k])
                   for k, v in enh.state_dict().items()):
            raise AssertionError("load_enhancer(best.pt) weights differ")
        del enh
        out_dir = os.path.join(root, "enhanced")
        t0 = time.perf_counter()
        infer.main(["--data_root", data_root, "--checkpoint", best,
                    "--output_dir", out_dir, "--device", "cuda"])
        infer_s = time.perf_counter() - t0
        outs = sorted(os.listdir(out_dir))
        if len(outs) != len(LOOP_TEST_S):
            raise AssertionError(f"infer wrote {outs}")
        for i, sec in enumerate(LOOP_TEST_S):
            wave, sr = read_wav(os.path.join(out_dir, f"test{i:03d}.wav"))
            if (sr != SR or wave.shape != (1, int(sec * SR))
                    or not np.isfinite(wave).all()):
                raise AssertionError(f"infer output {i}: {wave.shape}")

        e2 = full["epochs"][1]
        emit({"phase": "loop", "config": "TrainConfig() B=8 x 2 s, 2 epochs",
              "steps_per_epoch": per_epoch, "launches": got,
              "step_ms_in_loop_median_epoch2": statistics.median(
                  e2["step_ms"]),
              "step_ms_in_loop": [e["step_ms"] for e in full["epochs"]],
              "bare_step_ms_b8": bare_step_ms,
              "epoch_seconds": [e["seconds"] for e in full["epochs"]],
              "epoch_audio_sec_per_s": [e["audio_sec_per_s"]
                                        for e in full["epochs"]],
              "val_seconds": [e["val_seconds"] for e in full["epochs"]],
              "ckpt_seconds": [e["ckpt_seconds"] for e in full["epochs"]],
              "resumed_epoch2_train_profiled": idle,
              "resumed_epoch2_audio_sec_per_s":
                  resumed["epochs"][0]["audio_sec_per_s"],
              "resume_bit_equal": same, "best_epoch": full["best_epoch"],
              "best_val_mrstft": full["best_val"],
              "profile_steps_trace_kernels": n_kernels,
              "infer_outputs": len(outs), "infer_seconds": infer_s,
              "device": card})
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Exported program on the card vs make_enhance on the same card and input:
# the same kernels in the same order, so equal is expected; 1e-5 is far
# below TOL_WAVE (a wiring fault is O(0.1)). The same program in a fresh
# process (given this process's cuDNN flags) is held to TOL_WAVE, the
# enhance phase's band for another order of f32 sums: another process may
# pick another cuDNN algorithm, and a bf16 kernel operand that lands across
# a rounding boundary moves the output by up to ~1e-4 (bit equality is
# reported, not required).
TOL_EXPORT = 1e-5
PT_CHECKPOINT = os.path.join(ROOT, "artifacts", "train_demo",
                             "enhancer_best_reference_format.pt")


def program_call(torch, program):
    """An exported program as `enhance(x) -> enhanced`, under inference
    mode (as ExportedEnhancer runs it)."""
    def call(x):
        with torch.inference_mode():
            return program(x)[0]
    return call


def memcpy_count(torch, fn):
    """Host <-> device copies during one call of `fn` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "Memcpy HtoD" in e.name or "Memcpy DtoH" in e.name]
    return len(names)


def run_in_subprocess(code, *args, timeout=600):
    """`python3 -c code args` in a fresh process; its last stdout line as
    JSON. Raises with its stderr when it fails."""
    import subprocess

    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed (rc {proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# A keep_kernels artifact in a fresh process that imports the package: the
# program of the saved input's shape on it, its launches and output.
LOAD_KEPT = """
import json, sys
import numpy as np, torch
torch.backends.cudnn.deterministic = sys.argv[4] == "True"
from lct_gan_tpu_torch.export_model import load_exported
from lct_gan_tpu_torch.ops import banded_mhsa, fused_ftf_block, fused_mhsa
enh = load_exported(sys.argv[1], device="cuda")
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
with torch.inference_mode():
    out = enh.programs[tuple(x.shape)](x)[0]
torch.cuda.synchronize()
np.save(sys.argv[3], out.cpu().numpy())
print(json.dumps({"launches": [fused_ftf_block.launches, fused_mhsa.launches,
                               banded_mhsa.launches]}))
"""

# A portable artifact in a fresh process that imports torch and nothing of
# this repository.
LOAD_PORTABLE = """
import io, json, sys, zipfile
import numpy as np, torch
from torch.export.passes import move_to_device_pass
torch.backends.cudnn.allow_tf32 = False   # the program's convs are f32
torch.backends.cudnn.deterministic = sys.argv[4] == "True"
with zipfile.ZipFile(sys.argv[1]) as z:
    meta = json.loads(z.read("meta.json"))
    b, t = meta["shapes"][0]
    program = torch.export.load(io.BytesIO(z.read(f"b{b}_t{t}.pt2")))
module = move_to_device_pass(program, "cuda").module()
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
with torch.inference_mode():
    out = module(x)[0]
np.save(sys.argv[3], out.cpu().numpy())
ours = sorted(m for m in sys.modules if m.split(".")[0] in
              ("lct_gan_tpu", "lct_gan_tpu_torch", "jax"))
print(json.dumps({"repo_modules": ours}))
sys.exit(1 if ours else 0)
"""


def check_export(torch, np, card):
    """The export path (export_model.py) and the tools around it on the
    card, with the committed reference-format demo weights."""
    import contextlib
    import importlib.util
    import io
    import shutil
    import statistics
    import tempfile

    from lct_gan_tpu_torch import bench_serving_latency, export_cli
    from lct_gan_tpu_torch import metrics_cli
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import read_scp, read_wav, write_wav
    from lct_gan_tpu_torch.eval import (ModelComparator, enhance_in_chunks,
                                        make_enhance, make_torch_system)
    from lct_gan_tpu_torch.export_model import (export_enhancer,
                                                kernel_op_counts,
                                                load_exported)

    names = ("fused_ftf_block", "fused_mhsa", "banded_mhsa")
    launches = {k: 0 for k in names}
    rng = np.random.default_rng(12)
    root = tempfile.mkdtemp(prefix="lct_export_")
    try:
        # keep_kernels artifacts: (shapes, max_time_context, expected
        # launches per call (FTF, MHSA, banded) for each shape).
        for label, shapes, mtc, expects in (
                ("kept", [(128, 32000), (4, 163840)], None,
                 [(3, 0, 0), (2, 1, 0)]),
                ("kept_banded64", [(4, 196608)], 64, [(2, 0, 1)])):
            enhancer = load_enhancer(PT_CHECKPOINT, device="cuda",
                                     max_time_context=mtc)
            enhance = make_enhance(enhancer)
            path = os.path.join(root, f"{label}.lct.zip")
            export_s = export_enhancer(path, enhancer, shapes,
                                       keep_kernels=True)
            t0 = time.perf_counter()
            loaded = load_exported(path, device="cuda")
            load_s = time.perf_counter() - t0
            for shape, expect in zip(shapes, expects):
                program = loaded.programs[shape]
                nodes = kernel_op_counts(program)
                want_nodes = {k: n for k, n in zip(names, expect) if n}
                if nodes != want_nodes:
                    raise AssertionError(f"{label} {shape}: op nodes {nodes}"
                                         f", expected {want_nodes}")
                wave = (0.1 * rng.standard_normal(shape)).astype(np.float32)
                x = torch.from_numpy(wave).cuda()
                call = program_call(torch, program)
                call(x)  # warm-up
                out, got = run_counted(torch, call, x, None,
                                       dict(zip(names, expect)))
                for k in names:
                    launches[k] += got[k]
                ref = enhance(x)
                err = (out - ref).abs().max().item()
                if not (err <= TOL_EXPORT and torch.isfinite(out).all()):
                    raise AssertionError(f"{label} {shape} vs make_enhance: "
                                         f"{err} > {TOL_EXPORT}")
                res = {"phase": "export", "artifact": label,
                       "max_time_context": mtc, "shape": list(shape),
                       "op_nodes": nodes, "launches_per_call": got,
                       "max_abs_err_vs_make_enhance": err,
                       "bit_equal": bool(torch.equal(out, ref)),
                       "tol": TOL_EXPORT,
                       "export_s": export_s[shape], "load_s_all_shapes":
                           load_s, "device": card}
                if shape == (128, 32000):
                    # Custom-op dispatch overhead: the exported program
                    # against eager make_enhance, alternating.
                    runs = {"exported_ms": [], "make_enhance_ms": []}
                    for _ in range(2):
                        runs["exported_ms"].append(cuda_ms(torch,
                                                           lambda: call(x), 5))
                        runs["make_enhance_ms"].append(
                            cuda_ms(torch, lambda: enhance(x), 5))
                    res.update({k: statistics.median(v)
                                for k, v in runs.items()})
                    res["runs_ms"] = runs
                    # The same artifact in a fresh process.
                    np.save(os.path.join(root, "x.npy"), wave)
                    t0 = time.perf_counter()
                    sub = run_in_subprocess(
                        LOAD_KEPT, path, os.path.join(root, "x.npy"),
                        os.path.join(root, "y.npy"),
                        str(torch.backends.cudnn.deterministic))
                    sub_out = np.load(os.path.join(root, "y.npy"))
                    sub_err = float(np.abs(sub_out - out.cpu().numpy()).max())
                    if (sub["launches"] != [3, 0, 0]
                            or not sub_err <= TOL_WAVE):
                        raise AssertionError(f"fresh-process load: {sub}, "
                                             f"max|diff| {sub_err}")
                    res["fresh_process"] = {
                        "launches": sub["launches"],
                        "max_abs_err_vs_this_process": sub_err,
                        "bit_equal": sub_err == 0.0, "tol": TOL_WAVE,
                        "seconds": time.perf_counter() - t0}
                emit(res)
                del x, out, ref
            del loaded, enhancer, enhance
            torch.cuda.empty_cache()

        # The portable artifact: traced on the CPU, ATen ops only.
        enhancer = load_enhancer(PT_CHECKPOINT, device="cpu")
        path = os.path.join(root, "portable.lct.zip")
        shape = (8, 32000)
        export_s = export_enhancer(path, enhancer, [shape])
        t0 = time.perf_counter()
        loaded = load_exported(path, device="cuda")
        load_s = time.perf_counter() - t0
        program = loaded.programs[shape]
        if kernel_op_counts(program):
            raise AssertionError("portable program holds kernel ops")
        wave = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        x = torch.from_numpy(wave).cuda()
        call = program_call(torch, program)
        call(x)  # warm-up
        out, got = run_counted(torch, call, x, None,
                               {k: 0 for k in names})
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref, _ = enhancer(torch.from_numpy(wave))
            cpu_s = time.perf_counter() - t0
        err = (out.cpu() - ref).abs().max().item()
        if not (err <= TOL_WAVE and torch.isfinite(out).all()):
            raise AssertionError(f"portable on the card vs CPU plain path: "
                                 f"{err} > {TOL_WAVE}")
        copies = memcpy_count(torch, lambda: call(x))
        if copies:
            raise AssertionError(f"portable call made {copies} host copies")
        np.save(os.path.join(root, "x8.npy"), wave)
        t0 = time.perf_counter()
        sub = run_in_subprocess(LOAD_PORTABLE, path,
                                os.path.join(root, "x8.npy"),
                                os.path.join(root, "y8.npy"),
                                str(torch.backends.cudnn.deterministic))
        sub_s = time.perf_counter() - t0
        sub_err = float(np.abs(np.load(os.path.join(root, "y8.npy"))
                               - out.cpu().numpy()).max())
        if not sub_err <= TOL_WAVE:
            raise AssertionError(f"portable artifact: fresh torch-only "
                                 f"process max|diff| {sub_err}")
        card_enhance = make_enhance(load_enhancer(PT_CHECKPOINT,
                                                  device="cuda"))
        emit({"phase": "export", "artifact": "portable", "shape": list(shape),
              "launches_per_call": got, "max_abs_err_vs_cpu_plain": err,
              "tol_wave": TOL_WAVE, "host_copies_per_call": copies,
              "fresh_torch_only_process": {
                  "max_abs_err_vs_this_process": sub_err,
                  "bit_equal": sub_err == 0.0, "seconds": sub_s, **sub},
              "export_s": export_s[shape], "load_s": load_s,
              "ms_per_call": cuda_ms(torch, lambda: call(x), 5),
              "make_enhance_ms_b8": cuda_ms(torch, lambda: card_enhance(x),
                                            5),
              "cpu_plain_s": cpu_s, "device": card})
        del loaded, program, x, out, card_enhance
        torch.cuda.empty_cache()

        # The CLIs on the loop phase's synthetic corpus: export_cli writes
        # a keep_kernels artifact of 4 rows x 4 s, which enhances the test
        # set (1.5-9 s) in 4 s chunks with 0.5 s crossfades
        # (enhance_in_chunks: up to 3 chunks a wave, padded to 4 rows);
        # metrics_cli scores the result.
        data_root = os.path.join(root, "data")
        write_corpus(np, data_root)
        cli_path = os.path.join(root, "cli.lct.zip")
        t0 = time.perf_counter()
        export_cli.main(["--checkpoint", PT_CHECKPOINT, "--output", cli_path,
                         "--batch_size", "4", "--seconds", "4",
                         "--keep_kernels"])
        cli_export_s = time.perf_counter() - t0
        exported = load_exported(cli_path, device="cuda")
        out_dir = os.path.join(root, "enhanced")
        os.makedirs(out_dir)
        ids = read_scp(os.path.join(data_root, "test.scp"))
        for u in ids:
            wave = read_wav(os.path.join(data_root, "noisy_test",
                                         f"{u}.wav"))[0][0]
            write_wav(os.path.join(out_dir, f"{u}.wav"), enhance_in_chunks(
                exported, wave, SR, 4.0, 0.5), SR)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            metrics_cli.main(["--data_root", data_root, "--enhanced_dir",
                              out_dir, "--no_pesq"])
        lines = buf.getvalue().splitlines()
        if lines[0] != f"Evaluated {len(ids)}/{len(ids)} utterances":
            raise AssertionError(f"metrics_cli: {lines}")
        emit({"phase": "export", "tool": "export_cli + metrics_cli",
              "artifact_shapes": exported.shapes, "chunk_seconds": 4.0,
              "overlap_seconds": 0.5,
              "export_cli_s": cli_export_s, "metrics_cli": lines,
              "device": card})
        del exported

        # ModelComparator with the port's system on one utterance; PNGs
        # where matplotlib is installed.
        plots = importlib.util.find_spec("matplotlib") is not None
        cmp_dir = os.path.join(root, "compare")
        result = ModelComparator(
            {"port": make_torch_system(PT_CHECKPOINT)},
            plots=plots).process_one_file(
                os.path.join(data_root, "noisy_test", f"{ids[0]}.wav"),
                cmp_dir, os.path.join(data_root, "clean_test",
                                      f"{ids[0]}.wav"))
        files = sorted(os.listdir(cmp_dir))
        pngs = (sorted(os.listdir(os.path.join(cmp_dir, "spectrograms")))
                if plots else [])
        want = ["clean.wav", "noisy.wav", "port.wav", "port_diff.wav",
                "port_diff_norm.wav"] + (["spectrograms"] if plots else [])
        if not (files == want and pngs == (
                ["all.png", "clean.png", "noisy.png", "port.png",
                 "port_diff.png"] if plots else [])
                and all(np.isfinite(result["port"][k])
                        for k in ("si_sdr", "stoi"))):
            raise AssertionError(f"ModelComparator: {files}, {pngs}, "
                                 f"{result}")
        emit({"phase": "export", "tool": "ModelComparator",
              "utterance": ids[0], "metrics": {
                  k: {m: result[k].get(m) for m in ("si_sdr", "pesq", "stoi")}
                  for k in ("noisy", "port")},
              "files": files, "spectrograms": pngs if plots
              else "not written: no matplotlib on this machine",
              "device": card})

        # The serving-latency tool, as a user runs it; a row per line.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_serving_latency.main(["--iters", "5", "--repeats", "3"])
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        for row in report["rows"]:
            emit({"phase": "export", "tool": "bench_serving_latency",
                  **row, "device": report["device"]})
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    del enhancer
    torch.cuda.empty_cache()
    for phase in (check_banded, check_stream):
        for k, n in phase(torch, np, card).items():
            launches[k] += n
    train_launches, state, step_ms = check_train(torch, np, card)
    for k, n in train_launches.items():
        launches[k] += n
    check_eval(torch, np, card, state)
    del state
    torch.cuda.empty_cache()
    for k, n in check_loop(torch, np, card, step_ms[8]).items():
        launches[k] += n
    for k, n in check_export(torch, np, card).items():
        launches[k] += n

    summary = []
    for name, src, replaces, head_L in (
            ("fused_ftf_block", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/ftf.py:132", 33),
            ("fused_mhsa", "lct_gan_tpu_torch/csrc/mhsa.cu",
             "lct_gan_tpu/ops/attention.py:125", 644),
            ("banded_mhsa", "lct_gan_tpu_torch/csrc/banded.cu",
             "lct_gan_tpu/ops/banded_attention.py:109", 772),
            ("fused_ftf_bwd", "lct_gan_tpu_torch/csrc/ftf_bwd.cu",
             "lct_gan_tpu/ops/ftf_bwd.py:119", 33)):
        head = next(r for r in kernels[name]
                    if r["L"] == head_L and r["mode"] == "bf16")
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the path")
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **{k: head[k] for k in ("design", "exp_floor_ms",
                                    "library_mha_ms", "stages_ms",
                                    "scratch_bytes") if k in head},
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

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
        del state
        torch.cuda.empty_cache()
    return got, state0


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
    train_launches, state = check_train(torch, np, card)
    for k, n in train_launches.items():
        launches[k] += n
    check_eval(torch, np, card, state)
    del state

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

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed S]

Phases, each printing one JSON line (any failure raises, exit code != 0):

  device   require CUDA; print the card's nvidia-smi name and power limit
  build    build the CUDA kernels from lct_gan_tpu_torch/csrc (nvcc, sm_90a,
           one nvcc process a source and width): kernel width 64 (every
           source) and 128's forward in one parallel batch, then every
           other width (16 .. 512) forward and backward in a
           background thread at niceness 19 under the kernels, enhance and
           widths phases (the channels phase waits for it), with the
           seconds and ptxas counts of the kernel width 512 backward; the
           kernel width 64 instances' ptxas registers and spills beside the
           reference's (lct_gan_tpu_torch/ptxas_c64.json: before the true
           width and the score scale became launch arguments)
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
           fused_grouped_gru (LN1 + the composed time block's GRU, all
           f32, one launch; within TOL_GRU = 1e-5) at the 131,072- and
           163,840-sample buckets' time blocks and the banded
           917,504-sample call's (N = 132, L = 3,588), each with its
           sequential floor (the same call on one sequence), also against
           one cuDNN torch.nn.GRU(64, 64) call with block-diagonal weights,
           and one sequence of each slot kind the kernel runs; fused_ftf_bwd at the B=64 x
           2 s training shapes (all 15 gradients, relative to each one's
           largest magnitude; its lines also carry the design, the device
           ms of each stage, from one torch.profiler pass, and the bytes of
           scratch one launch allocates, read from the caching allocator's
           peak), and the
           save-hidden forward under grad
  enhance  the committed demo weights through load_enhancer + make_enhance:
           B=128 x 2 s (3 FTF launches, 0 MHSA; matches the plain path run
           on the CPU) and one bucketed batch of 163,840 samples with
           lengths (2 FTF launches, 1 MHSA, 1 GRU; rows match the CPU plain
           path)
  widths   the four forward kernels (FTF block, MHSA, banded, the composed
           GRU) at every num_heads and GRU group count dividing 64, against
           their plain versions on the card, bf16 and precise (the GRU f32),
           at small N: the FTF block (frequency L = 33; time L = 129 with
           key bias and a band of 16) at each head count with 4 groups, each
           group count with 4 heads, and (2, 2), (8, 8); MHSA at L = 516 and
           banded at S = 772, W = 64 at each head count; the GRU at L = 516
           at each group count; then, at the main path's shapes (several
           items a block), heads 1, 2, 4, 8 and 64 (each padded head width)
           for the FTF time block (N = 4,224), MHSA (L = 644, N = 825) and
           banded (N = 660); each case's max|diff|, ms, plain ms, bound
           (useful and padded products) and library ms (SDPA, one
           multi_head_attention_forward, one cuDNN GRU; or why none).
           Then enhancers with random
           weights from --seed at (heads, groups) = (8, 8) and (2, 2), B=128
           x 2 s (3 FTF launches), and at (8, 8) 4 x 163,840 samples (2 FTF,
           1 MHSA, 1 GRU) and, with max_time_context=64, 4 x 196,608 (2 FTF,
           1 banded, 1 GRU), each against the plain path on the card (the
           ops' plain versions under a dispatch mode)
  channels the four forward kernels at bottleneck widths C = 16, 32, 48, 96,
           128 and 8, 24, 40, 50, 80 (libraries built per kernel width,
           -DLCT_C; the wrappers pad every other C to the kernel width of
           its padded layout: 8 to 16, 24 to 32, 40 and 48 to 64, 50, 80
           and 96 to 128): every head count and GRU group count dividing C
           against the plain versions on the card at small N, both modes
           (the FTF block: frequency, time with key bias, time with
           lookback 16; MHSA at L = 516; banded at S = 772, W = 64; the
           composed GRU at L = 516, f32); at C = 32, 40, 80 and 128 with 4
           heads and 4 groups the main path's shapes (FTF frequency N =
           16,512 x 33 and time N = 4,224 x 129 with key bias and W = 16,
           MHSA N = 825 x 644, banded N = 660 x 772, GRU N = 825 x 644),
           timed with the bound, the library call and the wrapper's
           padding ms; LctEnhancer at enc_channels (8, 16, 32) and (32, 64,
           128), and (16, 32, 40) at 4 heads and groups and (16, 32, 50) at
           5 (kernel width 128), with random weights from --seed, B = 128 x
           2 s (3 FTF launches), and at (32, 64, 128), (16, 32, 40) and
           (16, 32, 50) 4 x 163,840 samples (2 FTF, 1 MHSA, 1 GRU) and with
           max_time_context=64 4 x 196,608 (2 FTF, 1 banded, 1 GRU),
           against the plain path on the card (worst row's relative L2
           error); training taken at other widths (train states at (32,
           64, 128) and (16, 32, 40), FTF blocks under grad at C = 48 and
           50), serving and a train state taken at (16, 32, 100) with 5
           heads and groups (a layout of 160 channels) and (16, 32, 144)
  width256 kernel width 256 (layouts of 129-256 channels): the four
           forward kernels against their plain versions on the card at C =
           256 at W256_PAIRS and the padded W256_PADDED layouts, small N,
           both modes; the main path's shapes at (256, 4, 4) and (256, 1,
           1), timed with stages; enhancers at enc_channels (64, 128, 256)
           against the plain path on the card; a train state at (64, 128,
           256) and the FTF block under grad at C = 256 taken (launches
           counted), serving and a train state at (64, 128, 272) (kernel
           width 512) taken
  width512 kernel width 512 (layouts of 257-512 channels), serving:
           width 512's ptxas registers, spills and static shared memory;
           the four forward kernels against their plain versions on the
           card at C = 512 at W512_PAIRS (every GRU slot kind: 16, 64, 128,
           the clusters' 256, the step kernel's 512; every head width 8 ..
           512) and the padded W512_PADDED layouts, small N, both modes;
           the main path's shapes at (512, 4, 4) and (512, 1, 1), timed
           with stages, plain and library ms; enhancers at enc_channels
           (128, 256, 512) against the plain path on the card with launch
           counts and peak memory (B = 128 x 2 s, a 163,840-sample bucket,
           a W = 64 banded call at 4 and 4, the bucket at 1 and 1); a
           train state at (128, 256, 512) (no launch) and the FTF block
           under grad at C = 512 (1 + 1 launches) taken; a train state at
           (64, 128, 520), serving at (64, 128, 520) and at (400, 5, 5)
           refused by name before any launch
  banded   the same weights with max_time_context=64, bucketed batches with
           lengths: 196,608 samples x 20 and 917,504 x 4 (2 FTF, 0 MHSA,
           1 banded, 1 GRU launches each) and 163,840 x 25 (2 FTF, 1 MHSA, 0
           banded, 1 GRU); rows match the CPU plain path; the composed GRU
           operator's ms at each call's time block
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
  train_widths  training at heads and GRU groups other than 4 and 4: the
           FTF backward kernel against its plain version on the card, all 15
           gradients, both modes, at every (heads, groups) pair of the
           widths phase (frequency block L = 33, time block L = 129 with
           lookback 16, small N), then at the B=64 x 2 s training shapes at
           heads 1, 2, 8 (4 groups) and groups 1, 2, 8 (4 heads), timed
           with stages, scratch, plain and library (SDPA forward +
           backward) ms; create_state + make_train_step with seeded
           weights at (8, 8) and (2, 2), B=8 x 2 s: 3 FTF forward and 3
           backward launches a step over three steps, finite metrics, two
           runs from one state bit-equal, one step against the plain path
           on the card (losses; precise also every tensor's change); then
           train_cli --num_heads 8 --gru_groups 8 for one epoch on the loop
           phase's corpus, in a subprocess
  train_channels  training at bottleneck widths C = 16, 32, 48, 96, 128
           and 8, 24, 40, 50, 80: the FTF backward against its plain
           version on the card, all 15 gradients, both modes, at 3-4
           (heads, groups) pairs a width of the first five and every head
           and group count of the others (frequency block L = 33, time
           block L = 129 with lookback 16, small N), then at the B=64 x 2 s
           training shapes at C = 32, 40, 80 and 128 (timed with stages,
           scratch, plain and library ms); make_train_step on states
           assembled around enhancers at enc_channels (8, 16, 32), (12, 24,
           48), (32, 64, 128), (16, 32, 40) and (16, 32, 50) at 5 heads and
           groups, B=8 x 2 s: 3 FTF forward and 3 backward launches a step
           over three steps, finite metrics, one step against the plain
           path on the card (losses; precise also every tensor's change).
           Then kernel width 256: the backward at C = 256 at W256_PAIRS and
           at W256_PADDED (frequency block N = 256, L = 33; time block N =
           64, L = 129, band 16), both modes; at the B=64 x 2 s shapes at
           W256_MAIN, timed with stages, scratch, peak GiB, plain and
           library ms (precise timed once a case); the train step at enc_channels W256_ENC at (4, 4)
           and (1, 1), counted and against the plain path as above. Then
           kernel width 512 in the same way: the backward at C = 512 at
           W512_PAIRS (GRU slots of 16 .. 512: the cluster walk on slots
           of 256, the step-synchronous walk on one of 512) and at
           W512_PADDED, both modes; the saved hiddens of the width-512
           forward under grad at W512_MAIN against the plain forward; the
           B=64 x 2 s shapes at W512_MAIN (precise timed once a case); the
           train step at enc_channels W512_ENC at W512_MAIN
  eval     make_eval_step on one bucketed batch with lengths, against the CPU
  parallel data parallelism (parallel/mesh.py) with the same weights and
           TrainConfig(): 2 ranks sharing the card over gloo (spawned),
           global B=8 x 2 s (4 rows a rank), 3 steps: the ranks' parameters,
           buffers and AdamW states bit-equal after every step, 3 FTF
           forward and 3 FTF backward launches per rank per step, step 1
           against the 1-rank B=8 step on the card (metrics rtol 2e-4 atol
           1e-6, parameters rtol 1e-3 atol 1e-5), each rank's step ms and
           all-reduce ms (CUDA events around the D and G reductions); the
           tiny parallel.dryrun; NCCL with one card a rank (the same 3
           steps, the same checks) where there are 2 cards, else a line
           saying it was not run
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
           pass; the corpus decoded by the native library alone (host ms per
           utterance, native against numpy, is host time); then
           train_cli --data_parallel 2 for one epoch (one set of
           checkpoints, configs.json with 2 devices and the backend,
           validation within rtol 2e-4 of the 1-rank validation of its
           best.pt)
  export   the export path with the reference-format demo weights:
           keep_kernels artifacts traced on the card at (128, 32000) and
           (4, 163840) (3/0/0/0 and 2/1/0/1 FTF/MHSA/banded/GRU launches per
           call, counted from the loaded program) and, with
           max_time_context=64, at (4, 196608) (2/0/1/1), each against
           make_enhance on the same
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
  accept   the driver entry point entry.py with the demo weights: fn on a
           seeded (8, 32000) wave against entry(device="cpu") (TOL_WAVE),
           3/0/0 FTF/MHSA/banded launches a call, finite on its zeros
           example, the median ms of 5 calls; then `python -m
           lct_gan_tpu_torch.acceptance --synthetic` in a subprocess: rc 0,
           stages 2/3/4/1/5 PASS and the parity gate G SKIP, wall seconds

then the "kernels" summary line and, last, {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "train_demo",
                          "g_params_best.npz")
# Registers and spills of the kernel width 64 instances before the true
# width and the score scale became launch arguments (ptxas_report).
PTXAS_REFERENCE = os.path.join(ROOT, "lct_gan_tpu_torch", "ptxas_c64.json")
SR = 16000

# Kernel vs plain version on the same inputs, both on the card.
#   precise: both all-f32; only the order of f32 sums and the last ulp of
#     exp/tanh/rsqrt differ.
#   bf16: both round the same operands to bf16; a sum order that lands an
#     intermediate on the other side of a bf16 rounding boundary moves it by
#     one bf16 ulp (2^-8 relative). 3e-2 is the JAX package's own band for
#     its bf16 kernel (tests/test_pallas_ftf.py); a wiring fault is O(1).
TOL = {"precise": 1e-3, "bf16": 3e-2}
# fused_grouped_gru against grouped_gru_plain, both all f32 in every mode:
# only the sums' order and a few ulps of the kernel's ex2 / reciprocal
# gates differ, and the GRU's gates keep them from growing along L.
TOL_GRU = 1e-5
# Enhancer on the card (kernels) vs on the CPU (plain path), both bf16 mode:
# the mask is a sigmoid in [0, 1], the waveform ~0.1 * N(0, 1) input times a
# decompressed mask (d(m^(1/0.3)) <= 3.4 dm).
TOL_MASK = 2e-2
TOL_WAVE = 1e-2


def tol_of(kernel, mode):
    """The tolerance a kernel's cases are held to in `mode`."""
    return TOL_GRU if kernel == "fused_grouped_gru" else TOL[mode]


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


def stage_profile(torch, fn, prefix="", reps=3, event_ms=None, passes=3):
    """{prefix + "stages_ms": device ms per call of each stage of `fn`,
    largest first, or None; prefix + "stages_coverage": the share of the
    calls' device time (CUDA events around `reps` calls, unprofiled) the
    stages add up to}. One torch.profiler pass over `reps` calls after one
    warm-up. The profiler can lose kernels (late in a long run on the H100
    it kept from none to all of a pass's), so a pass counts only if each
    stage shows a multiple of `reps` launches and its stages cover 85% to
    110% of the events' ms (below 100%: idle between launches); up to
    `passes` passes, else stages_ms is None and the coverage the best
    pass's. `event_ms`: the events' ms a call, measured by the caller
    (no warm-up or events here)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if event_ms is None:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / reps
    best = 0.0
    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if us > 0:
                key = stage_of(evt.key)
                out[key] = out.get(key, 0.0) + us / reps / 1e3
                counts[key] = counts.get(key, 0) + evt.count
        coverage = sum(out.values()) / event_ms
        if abs(coverage - 1) < abs(best - 1):
            best = coverage
        if (out and all(n % reps == 0 for n in counts.values())
                and 0.85 <= coverage <= 1.1):
            return {prefix + "stages_ms": dict(
                        sorted(out.items(), key=lambda kv: -kv[1])),
                    prefix + "stages_coverage": coverage}
    return {prefix + "stages_ms": None, prefix + "stages_coverage": best}


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


def bound(rows, flops, extra_bytes, mode, C=64):
    nbytes = 2 * rows * C * 4 + extra_bytes   # x read + out written
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[mode]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_banded_ms(torch, N, L, lookback, mode, num_heads=4, C=64):
    """`library_attention_ms` with the band mask, forced onto the
    memory-efficient backend. Returns (ms, None) or (None, reason)."""
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return library_attention_ms(torch, N, L, lookback, None,
                                        mode, num_heads, C), None
    except (ImportError, RuntimeError) as exc:  # unsupported or out of
        torch.cuda.empty_cache()                # memory: record why
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


def library_attention_ms(torch, N, L, lookback, key_bias, mode,
                         num_heads=4, C=64):
    """One scaled_dot_product_attention call on the same attention shapes
    (a yardstick only: the port never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((N, num_heads, L, C // num_heads), generator=g,
                           device="cuda", dtype=dt) for _ in range(3))
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


def library_mha_ms(torch, x, params, key_bias, mode, num_heads=4):
    """The whole MHSA function in one PyTorch call:
    `multi_head_attention_forward` with the same weights, head count and
    key padding mask (a yardstick only: the port never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    in_w, in_b, out_w, out_b = (p.to(dt) for p in params)
    q = x.to(dt).transpose(0, 1)            # [L, N, E]
    pad = key_bias != 0                     # True: masked key

    def call():
        return F.multi_head_attention_forward(
            q, q, q, q.shape[-1], num_heads, in_w.t(), in_b, None, None,
            False, 0.0,
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

    results = {"fused_ftf_block": [], "fused_mhsa": [], "banded_mhsa": [],
               "fused_grouped_gru": []}
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
        # The composed time block's LN1 + grouped GRU at the same shape.
        res = check_grouped_gru(torch, gen.GRUt1, x, exp_floor_ms)
        results["fused_grouped_gru"].append(res)
        emit({"phase": "kernels", "kernel": "fused_grouped_gru", **res})
        del x, kb
        torch.cuda.empty_cache()
    # ... and at the banded 917,504-sample call's time block (4 rows x 33,
    # S = 3,588): few chains, each 3,588 steps long.
    x = torch.randn((132, 3588, 64), generator=g, device="cuda")
    res = check_grouped_gru(torch, gen.GRUt1, x, exp_floor_ms)
    results["fused_grouped_gru"].append(res)
    emit({"phase": "kernels", "kernel": "fused_grouped_gru", **res})
    del x
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "fused_grouped_gru",
          **check_gru_chains(torch, g)})

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
                res.update(stage_profile(
                    torch, lambda: fused_mhsa(x, *aparams, **kw),
                    "fused_mhsa_"))
            del out
            res["ms"] = cuda_ms(torch, lambda: banded_mhsa(x, *aparams, **kw),
                                5)
            res.update(stage_profile(
                torch, lambda: banded_mhsa(x, *aparams, **kw)))
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


def library_gru(torch, n1, w_ih, w_hh, b_ih, b_hh):
    """The grouped GRU as one cuDNN torch.nn.GRU(64, 64) call: the four
    groups' weights on a block-diagonal (a yardstick only: the port never
    calls it; TF32 off). Returns (ms, its output on n1)."""
    G, H = w_ih.shape[1], w_ih.shape[2]
    gru = torch.nn.GRU(G * H, G * H, batch_first=True).cuda()
    with torch.no_grad():
        for w, dst in ((w_ih, gru.weight_ih_l0), (w_hh, gru.weight_hh_l0)):
            dst.zero_()
            for k in range(3):       # gates r, z, n
                for g in range(G):
                    dst[k * G * H + g * H:k * G * H + (g + 1) * H,
                        g * H:(g + 1) * H] = w[0, g, :, k * H:(k + 1) * H].t()
        for b, dst in ((b_ih, gru.bias_ih_l0), (b_hh, gru.bias_hh_l0)):
            for k in range(3):
                for g in range(G):
                    dst[k * G * H + g * H:k * G * H + (g + 1) * H] = \
                        b[0, g, k * H:(k + 1) * H]
        out = gru(n1)[0]
        ms = cuda_ms(torch, lambda: gru(n1), 3)
    del gru
    return ms, out


def gru_kernel_slot(C, groups):
    """The slot width fused_grouped_gru's kernel runs `groups` groups of C
    channels in: each group's width once the wrapper has padded it to a
    power of two (ops/padding.py), or 16 holding narrower groups."""
    from lct_gan_tpu_torch.ops.padding import head_width

    return max(16, head_width(C // groups))


def check_gru_chains(torch, g, L=516):
    """fused_grouped_gru on one sequence of L steps (one block: nothing
    overlaps its steps) for each slot kind the kernel runs: 16 (C = 64, 4
    groups), 32 (2 groups), a dense 64 (1 group), two of 64 and one of 128
    at C = 128, each within TOL_GRU of the plain version. Returns the
    measured ms and ns a step of each."""
    from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain

    chains = []
    for C, G in ((64, 4), (64, 2), (64, 1), (128, 2), (128, 1)):
        H = C // G

        def u(*s):
            return 0.25 * (2 * torch.rand(s, generator=g, device="cuda") - 1)

        params = [1 + 0.1 * u(C), 0.1 * u(C), u(1, G, H, 3 * H),
                  u(1, G, H, 3 * H), u(1, G, 3 * H), u(1, G, 3 * H)]
        x = torch.randn((1, L, C), generator=g, device="cuda")
        out = fused_grouped_gru(x, *params, bidirectional=False)
        torch.cuda.synchronize()
        err = (out - grouped_gru_plain(x, *params, False)).abs().max().item()
        if not (err <= TOL_GRU) or not torch.isfinite(out).all():
            raise AssertionError(f"fused_grouped_gru chain C={C} groups={G}: "
                                 f"max|diff| {err} > {TOL_GRU}")
        ms = cuda_ms(torch, lambda: fused_grouped_gru(
            x, *params, bidirectional=False), 5)
        chains.append({"C": C, "groups": G, "slot": gru_kernel_slot(C, G),
                       "max_abs_err": err, "ms": ms, "step_ns": ms * 1e6 / L})
    return {"case": f"chains N1 L{L}", "mode": "precise", "tol": TOL_GRU,
            "chains": chains}


def check_grouped_gru(torch, block, x, exp_floor_ms):
    """fused_grouped_gru (one direction, all f32 in every mode) against its
    plain version on x [N, L, 64] within TOL_GRU, timed beside its bound,
    its sequential floor (measured: the same call on x's first sequence,
    one block, whose L steps nothing overlaps), the plain loop and one
    cuDNN GRU call on the LN1 output."""
    from lct_gan_tpu_torch.ops.gru import (GRU_DESIGN, fused_grouped_gru,
                                           grouped_gru_plain, layer_norm)

    params = [p.detach().contiguous() for p in block.kernel_params()[:6]]
    N, L, _ = x.shape
    rows = N * L
    out = fused_grouped_gru(x, *params, bidirectional=False)
    torch.cuda.synchronize()
    ref = grouped_gru_plain(x, *params, False)
    err = (out - ref).abs().max().item()
    if not (err <= TOL_GRU) or not torch.isfinite(out).all():
        raise AssertionError(f"fused_grouped_gru N={N} L={L}: max|diff| "
                             f"{err} > {TOL_GRU}")
    del ref
    ms = cuda_ms(torch, lambda: fused_grouped_gru(
        x, *params, bidirectional=False), 5)
    x1 = x[:1].contiguous()
    seq_floor_ms = cuda_ms(torch, lambda: fused_grouped_gru(
        x1, *params, bidirectional=False), 5)
    plain_ms = cuda_ms(torch, lambda: grouped_gru_plain(x, *params, False), 1)
    torch.cuda.empty_cache()
    # Products: the grouped input and hidden projections, 2 x 4 x 16 x 48
    # multiply-adds each a row; exps: two sigmoids and a tanh a unit.
    flops = rows * 2 * 2 * 4 * 16 * 48
    bms, by = bound(rows, flops, sum(p.numel() for p in params) * 4,
                    "precise")
    lib_ms, lib_out = library_gru(torch, layer_norm(x, *params[:2]),
                                  *params[2:])
    lib_err = (lib_out - out).abs().max().item()
    del out, lib_out
    torch.cuda.empty_cache()
    return {"case": f"L{L}", "mode": "precise", "design": GRU_DESIGN,
            "N": N, "L": L, "max_abs_err": err, "tol": TOL_GRU,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "seq_floor_ms": seq_floor_ms,
            "exp_floor_ms": exp_floor_ms(rows * 64 * 3),
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "flops": flops}


def check_saved_hidden(torch, name, params, N, L, lookback, g, num_heads=4,
                       phase="kernels"):
    """Under grad the FTF forward keeps the hiddens its kernels write: its
    output is bit-equal to the no-grad forward's, and the hiddens match the
    plain forward's (C from lin_w, params[12]: [2C or C, C])."""
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           ftf_forward_with_hidden,
                                           fused_ftf_block)

    C = params[12].shape[1]
    D = 2 if params[12].shape[0] == 2 * C else 1
    x = torch.randn((N, L, C), generator=g, device="cuda")
    for mode in ("bf16", "precise"):
        kw = dict(bidirectional=D == 2, num_heads=num_heads,
                  lookback=lookback, precise=mode == "precise")
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
        emit({"phase": phase, "check": "save-hidden forward",
              "case": name, "C": C, "num_heads": num_heads, "mode": mode,
              "output_bit_equal": True,
              "hid_max_abs_err": err, "tol": TOL[mode]})
        del hid, ref_hid
    del x
    torch.cuda.empty_cache()


def library_attention_bwd_ms(torch, N, L, lookback, mode, num_heads=4, C=64):
    """One scaled_dot_product_attention forward + backward on the same
    [N, num_heads, L, C / num_heads] attention (a yardstick only: the port
    never calls it)."""
    F = torch.nn.functional
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((N, num_heads, L, C // num_heads),
                               generator=g, device="cuda", dtype=dt)
                   for _ in range(4))
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


def ftf_bwd_flops(N, L, D, lin_in, lookback, groups=4, C=64):
    """Useful products of the FTF backward: the forward products it
    recomputes (qkv, out-proj, Linear, GRU input and hidden projections,
    attention scores and context) plus two products per GEMM for the
    gradients, and four per attention pair (dp, dq, dk, dv), each over the
    C channels of all heads together."""
    rows = N * L
    gemm = 2 * C * 3 * C + 2 * C * C + 2 * lin_in * C
    # grouped W_ih and W_hh per direction: C inputs to 3 * C / G units
    gru = D * 2 * (2 * C * 3 * (C // groups))
    return rows * 3 * (gemm + gru) + N * band_pairs(L, lookback) * 6 * 2 * C


BWD_NAMES = ("dx", "dln1s", "dln1b", "dw_ih", "dw_hh", "db_ih", "db_hh",
             "dln2s", "dln2b", "din_w", "din_b", "dout_w", "dout_b",
             "dlin_w", "dlin_b")


def ftf_bwd_case(torch, name, x, params, D, lookback, mode, g,
                 exp_floor_ms, num_heads=4, groups=4, timed=True):
    """fused_ftf_bwd against ftf_bwd_reference on the card, all 15
    outputs within TOL[mode] of each one's largest magnitude; its ms,
    bound and library time (with `timed`, also the plain version's ms,
    device ms per stage and scratch bytes; precise mode past C = 128,
    0.4-6 s a call, times one call after the checked one, its scratch
    too, and profiles one). Returns the case's record."""
    from lct_gan_tpu_torch.ops.ftf import ftf_forward_with_hidden
    from lct_gan_tpu_torch.ops.ftf_bwd import (ftf_bwd_reference,
                                               fused_ftf_bwd)

    N, L, C = x.shape
    rows = N * L
    lin_in = params[12].shape[0]
    kw = dict(bidirectional=D == 2, num_heads=num_heads, lookback=lookback,
              precise=mode == "precise")
    out, hid = ftf_forward_with_hidden(x, *params, **kw)
    # The LeakyReLU's derivative jumps at comb = 0, and two sum orders put
    # a comb within rounding noise of 0 on different sides (a 0.8 * dout
    # jump in that element's gradient). The cotangent is zeroed within
    # `eps` of the kink, so both versions compute the same smooth function
    # of their inputs.
    act = out - x - hid.sum(dim=0).reshape(N, L, C)
    comb = torch.where(act >= 0, act, act / 0.2)
    eps = 5e-2 if mode == "bf16" else 1e-3
    dout = torch.randn((N, L, C), generator=g, device="cuda")
    dout = torch.where(comb.abs() < eps, 0.0, dout)
    del out, act, comb
    got = fused_ftf_bwd(x, *params, hid, dout, **kw)
    torch.cuda.synchronize()
    design = fused_ftf_bwd.design
    want = ftf_bwd_reference(x, *params, hid, dout, **kw)
    rel = {n: ((a - b).abs().max() / b.abs().max()).item()
           for n, a, b in zip(BWD_NAMES, got, want)}
    abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    bad = {n: e for n, e in rel.items() if not e <= TOL[mode]}
    if bad or not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"fused_ftf_bwd {name} C={C} heads={num_heads} "
                             f"groups={groups} {mode}: relative errors "
                             f"over {TOL[mode]}: {bad}")
    del got, want
    torch.cuda.empty_cache()

    def call():
        return fused_ftf_bwd(x, *params, hid, dout, **kw)

    once = timed and C > 128 and mode == "precise"
    if once:  # the checked call was the warm-up; as scratch_bytes measures
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        result = call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        scratch = (torch.cuda.max_memory_allocated()
                   - torch.cuda.memory_allocated())
        del result
    else:
        ms = cuda_ms(torch, call, 3)
    flops = ftf_bwd_flops(N, L, D, lin_in, lookback, groups, C)
    nbytes = (rows * C * 4 * (2 + D)           # x, dout, hid
              + rows * C * 4                   # dx
              + 2 * sum(p.numel() for p in params) * 4)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[mode]
    # One exp per in-band attention pair and head, three per GRU unit per
    # row per direction (two sigmoids, one tanh).
    exps = N * num_heads * band_pairs(L, lookback) + rows * D * C * 3
    lib = library_or_reason(torch, lambda: library_attention_bwd_ms(
        torch, N, L, lookback, mode, num_heads, C))
    res = {"case": name, "mode": mode, "design": design, "C": C,
           "num_heads": num_heads, "gru_groups": groups, "N": N, "L": L,
           "max_abs_err": abs_err, "max_rel_err": max(rel.values()),
           "rel_err": rel, "tol": TOL[mode],
           "masked_share": (dout == 0).float().mean().item(), "ms": ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "exp_floor_ms": exp_floor_ms(exps), "library_ms": lib[0],
           "flops": flops}
    if lib[1] is not None:
        res["library_unavailable"] = lib[1]
    if timed:  # one call a profiled pass past C = 128: they are long
        if once:
            res.update(stage_profile(torch, call, reps=1, event_ms=ms,
                                     passes=1))
            res["scratch_bytes"] = scratch
        else:
            res.update(stage_profile(torch, call,
                                     reps=1 if C > 128 else 3))
            res["scratch_bytes"] = scratch_bytes(torch, call)
        res["plain_ms"] = cuda_ms(torch, lambda: ftf_bwd_reference(
            x, *params, hid, dout, **kw), 1)
    del hid, dout
    torch.cuda.empty_cache()
    return res


def check_ftf_bwd(torch, gen, g, exp_floor_ms):
    """fused_ftf_bwd against ftf_bwd_reference at the training shapes of
    B=64 x 2 s (4 heads, 4 GRU groups), all 15 outputs, both modes; each
    case's design, device ms per stage (stages_ms), scratch bytes and exp
    floor."""
    results = []
    for name, block, N, L, lookback in (
            ("freq", gen.GRUf1, 64 * 129, 33, None),
            ("time", gen.GRUt1, 64 * 33, 129, None),
            ("time_lookback16", gen.GRUt1, 64 * 33, 129, 16)):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        for mode in ("bf16", "precise"):
            res = ftf_bwd_case(torch, name, x, params, D, lookback, mode, g,
                               exp_floor_ms)
            results.append(res)
            emit({"phase": "kernels", "kernel": "fused_ftf_bwd", **res})
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
    from lct_gan_tpu_torch.ops.gru import fused_grouped_gru

    fused_ftf_block.launches = 0
    fused_mhsa.launches = 0
    banded_mhsa.launches = 0
    fused_ftf_bwd.launches = 0
    fused_grouped_gru.launches = 0
    out = enhance(x) if lengths is None else enhance(x, lengths)
    torch.cuda.synchronize()
    got = {"fused_ftf_block": fused_ftf_block.launches,
           "fused_mhsa": fused_mhsa.launches,
           "banded_mhsa": banded_mhsa.launches,
           "fused_ftf_bwd": fused_ftf_bwd.launches,
           "fused_grouped_gru": fused_grouped_gru.launches}
    expect = {"fused_ftf_bwd": 0, "fused_grouped_gru": 0, **expect}
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
                "fused_ftf_bwd": 0, "fused_grouped_gru": 0}
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
                            "banded_mhsa": 0, "fused_grouped_gru": 1})
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


# Every head count and GRU group count the kernels take at C = 64.
WIDTHS = (1, 2, 4, 8, 16, 32, 64)
# Heads whose head widths are each padded width of the attention kernels
# once (64, 32, 16, 8 channels), and 64 heads (8, in 16 rounds of four).
MAIN_HEADS = (1, 2, 4, 8, 64)


def plain_route(torch):
    """A dispatch mode under which each kernel op of the port, the FTF
    backward's too, computes its plain PyTorch version on the tensors' own
    device: the plain path on the card (no kernel launches, no count
    moves), for serving and for a train step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from lct_gan_tpu_torch.export_model import _plain_decompositions
    from lct_gan_tpu_torch.ops.ftf_bwd import ftf_bwd_op, ftf_bwd_plain

    table = {**_plain_decompositions(), ftf_bwd_op: ftf_bwd_plain}

    class PlainRoute(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return table.get(func, func)(*args, **(kwargs or {}))

    return PlainRoute()


def seeded_enhancer(torch, seed, num_heads, gru_groups, max_time_context=None):
    """An enhancer at these widths with its modules' own random init under
    `seed` (no trained weights exist at other widths), on the card."""
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enhancer = LctEnhancer(gen_cfg=LCTGeneratorConfig(
            num_heads=num_heads, gru_groups=gru_groups,
            max_time_context=max_time_context))
    return enhancer.cuda().eval()


def library_or_reason(torch, fn):
    """(ms, None) from one yardstick call, or (None, why) where the library
    cannot take the shapes (unsupported, or out of memory)."""
    try:
        return fn(), None
    except RuntimeError as exc:
        torch.cuda.empty_cache()
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


def by_rows(torch, plain, n_rows, row_bytes, budget=4 << 30):
    """The plain version over row chunks (`plain(lo, hi)`) whose
    intermediates (`row_bytes` a row) stay under `budget`, concatenated:
    each sequence's result depends on its own row alone."""
    step = max(1, budget // row_bytes)
    return lambda: torch.cat([plain(i, min(i + step, n_rows))
                              for i in range(0, n_rows, step)])


def width_case(torch, kernel, name, fn, plain, mode, shape, flops, padded,
               extra, exps, exps_per_s, nh, G, library, C=64,
               phase="widths", info=None):
    """One kernel at one width against its plain version on the same inputs
    on the card: max|diff| within TOL[mode], kernel and plain ms, the bound
    by the kernels table's formula on the useful products (`bound_ms`) and
    on the products the kernel issues with its padded widths
    (`padded_bound_ms`), and the library's time (`library()`: (ms, why not),
    and optionally its max|diff| from the kernel). C: the channel width;
    `info`: more fields for the case's record."""
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    err = (out - ref).abs().max().item()
    tol = tol_of(kernel, mode)
    if not (err <= tol) or not torch.isfinite(out).all():
        raise AssertionError(f"{kernel} {name} C={C} heads={nh} groups={G} "
                             f"{mode}: max|diff| {err} > {tol}")
    rel = err / max(ref.abs().max().item(), 1e-30)
    del out, ref
    torch.cuda.empty_cache()
    N, L = shape
    rows = N * L
    bms, by = bound(rows, flops, extra, mode, C)
    pbms, pby = bound(rows, padded, extra, mode, C)
    res = {"case": f"{phase} {name} h{nh} g{G}" + (
               "" if C == 64 else f" C{C}"), "mode": mode, "C": C,
           "num_heads": nh, "gru_groups": G, "N": N, "L": L, "rows": rows,
           "max_abs_err": err, "rel_err": rel, "tol": tol,
           "ms": cuda_ms(torch, fn, 3), "plain_ms": cuda_ms(torch, plain, 1),
           "bound_ms": bms, "bound_by": by, "padded_bound_ms": pbms,
           "padded_bound_by": pby, "flops": flops, "padded_flops": padded}
    lib = library()
    res["library_ms"] = lib[0]
    if lib[1] is not None:
        res["library_unavailable"] = lib[1]
    if len(lib) > 2:
        res["library_max_abs_err"] = lib[2]
    if exps:
        res["exp_floor_ms"] = exps / exps_per_s * 1e3
    res.update(info or {})
    emit({"phase": phase, "kernel": kernel, **res})
    torch.cuda.empty_cache()
    return res


def check_widths(torch, np, card, seed):
    """The four forward kernels at every head and GRU group count that
    divides 64, against their plain versions on the card in both modes, at
    small N; the attention kernels again at each padded head width (heads
    1, 2, 4, 8 and 64) at the main path's shapes, where a block takes more
    than one work item; then the enhancer end to end at (heads, groups) =
    (8, 8) and (2, 2), B = 128 x 2 s, and at (8, 8) one composed and one
    banded call, against the plain path on the card. Random weights from
    `seed`."""
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)
    from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru,
                                           grouped_gru_plain, gru_slot,
                                           layer_norm)
    from lct_gan_tpu_torch.ops.probe import ex2_rate

    t0 = time.perf_counter()
    exps_per_s = ex2_rate()
    g = torch.Generator(device="cuda").manual_seed(seed)
    results = {"fused_ftf_block": [], "fused_mhsa": [], "banded_mhsa": [],
               "fused_grouped_gru": []}

    def tail(N, L, n_valid_min):
        valid = torch.randint(n_valid_min, L + 1, (N,), generator=g,
                              device="cuda")
        pos = torch.arange(L, device="cuda")
        return torch.where(pos[None, :] < valid[:, None], 0.0,
                           -1e30).to(torch.float32)

    def head_flops(N, pairs, hd):
        """Attention products: (useful, issued). A head's scores take
        m16n8k16 steps of 16 channels and its context n8 tiles of 8."""
        nh = 64 // hd
        return (N * nh * pairs * hd * 4,
                N * nh * pairs * 2 * (max(hd, 16) + max(hd, 8)))

    def ftf_cases(nh, G, name, block, N, L, lookback):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kb = tail(N, L, L - 40) if D == 1 else None
        rows, lin_in, hd = N * L, params[12].shape[0], 64 // nh
        pairs_n = band_pairs(L, lookback)
        attn, attn_pad = head_flops(N, pairs_n, hd)
        rest = rows * (2 * 64 * 192 + 2 * 64 * 64 + 2 * lin_in * 64)
        gru = rows * 4 * D * 192 * (64 // G)
        gru_pad = rows * 4 * D * 192 * gru_slot(G)
        extra = (sum(p.numel() for p in params) * 4
                 + (rows * 4 if kb is not None else 0))
        exps = N * nh * pairs_n + rows * D * 64 * 3
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=D == 2, num_heads=nh, lookback=lookback,
                      precise=mode == "precise")

            def plain(lo, hi):
                return ftf_block_reference(
                    x[lo:hi], *params,
                    key_bias=None if kb is None else kb[lo:hi], **kw)

            results["fused_ftf_block"].append(width_case(
                torch, "fused_ftf_block", name,
                lambda: fused_ftf_block(x, *params, key_bias=kb, **kw),
                by_rows(torch, plain, N, 16 * nh * L * L), mode, (N, L),
                rest + gru + attn, rest + gru_pad + attn_pad, extra, exps,
                exps_per_s, nh, G, lambda: library_or_reason(
                    torch, lambda: library_attention_ms(
                        torch, N, L, lookback, kb, mode, nh))))
        del x, kb

    def attention_cases(nh, kernel, N, L, lookback):
        attn_mod = seeded_enhancer(torch, seed, nh, 4).gen.GRUt1.attn
        aparams = [p.detach().contiguous() for p in attn_mod.kernel_params()]
        fn, ref = {"fused_mhsa": (fused_mhsa, mhsa_reference),
                   "banded_mhsa": (banded_mhsa, banded_mhsa_reference)}[kernel]
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kb = tail(N, L, L - 130)
        rows = N * L
        pairs_n = band_pairs(L, lookback)
        attn, attn_pad = head_flops(N, pairs_n, 64 // nh)
        proj = rows * (2 * 64 * 192 + 2 * 64 * 64)
        # MHSA: two exps a pair (max and sum, then p); banded: one.
        exps = (2 if lookback is None else 1) * N * nh * pairs_n
        extra = sum(p.numel() for p in aparams) * 4 + rows * 4
        for mode in ("bf16", "precise"):
            kw = dict(num_heads=nh, precise=mode == "precise")
            if lookback is not None:
                kw["lookback"] = lookback
                library = lambda: library_banded_ms(  # noqa: E731
                    torch, N, L, lookback, mode, nh)
            else:
                library = lambda: library_or_reason(  # noqa: E731
                    torch, lambda: library_mha_ms(torch, x, aparams, kb,
                                                  mode, nh))

            def plain(lo, hi):
                return ref(x[lo:hi], *aparams, key_bias=kb[lo:hi], **kw)

            results[kernel].append(width_case(
                torch, kernel, f"L{L}_N{N}_keybias" + (
                    f"_W{lookback}" if lookback is not None else ""),
                lambda: fn(x, *aparams, key_bias=kb, **kw),
                by_rows(torch, plain, N, 16 * nh * L * L), mode, (N, L),
                proj + attn, proj + attn_pad, extra, exps, exps_per_s, nh, 4,
                library))
        del x, kb

    # FTF forward: every head count at 4 groups, every group count at 4
    # heads, and (2, 2), (8, 8); the frequency and the time block.
    pairs = sorted({(nh, 4) for nh in WIDTHS} | {(4, G) for G in WIDTHS}
                   | {(2, 2), (8, 8)})
    for nh, G in pairs:
        gen = seeded_enhancer(torch, seed, nh, G).gen
        ftf_cases(nh, G, "freq", gen.GRUf1, 512, 33, None)
        ftf_cases(nh, G, "time_keybias_lookback16", gen.GRUt1, 128, 129, 16)

    # MHSA (L = 516) and banded (S = 772, W = 64) at every head count.
    for nh in WIDTHS:
        attention_cases(nh, "fused_mhsa", 33, 516, None)
        attention_cases(nh, "banded_mhsa", 33, 772, 64)

    # Each padded head width (64, 32, 16, 8; 8 again in 16 rounds) at the
    # main path's shapes (the B = 128 x 2 s time block, the 163,840-sample
    # bucket's MHSA, the 196,608-sample W = 64 call's banded attention):
    # several items a block, so the persistent loop and the loads of the
    # next item run.
    for nh in MAIN_HEADS:
        gen = seeded_enhancer(torch, seed, nh, 4).gen
        ftf_cases(nh, 4, "time_keybias_lookback16_main", gen.GRUt1, 4224,
                  129, 16)
        attention_cases(nh, "fused_mhsa", 825, 644, None)
        attention_cases(nh, "banded_mhsa", 660, 772, 64)

    # The composed time block's LN1 + GRU (all f32) at every group count,
    # beside one cuDNN GRU over the same LN1 (block-diagonal weights).
    N, L = 33, 516
    for G in WIDTHS:
        block = seeded_enhancer(torch, seed, 4, G).gen.GRUt1
        params = [p.detach().contiguous() for p in block.kernel_params()[:6]]
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        rows = N * L

        def gru_fn():
            return fused_grouped_gru(x, *params, bidirectional=False)

        def library():
            lib_ms, lib_out = library_gru(
                torch, layer_norm(x, *params[:2]), *params[2:])
            return lib_ms, None, (lib_out - gru_fn()).abs().max().item()

        results["fused_grouped_gru"].append(width_case(
            torch, "fused_grouped_gru", f"L{L}", gru_fn,
            lambda: grouped_gru_plain(x, *params, False), "precise", (N, L),
            rows * 4 * 192 * (64 // G),
            rows * 4 * 192 * gru_kernel_slot(64, G),
            sum(p.numel() for p in params) * 4, rows * 64 * 3, exps_per_s,
            4, G, library))
        del x
    kernel_s = time.perf_counter() - t0

    # The enhancer end to end, each call against the plain path on the card.
    launches = {k: 0 for k in ("fused_ftf_block", "fused_mhsa",
                               "banded_mhsa", "fused_ftf_bwd",
                               "fused_grouped_gru")}
    rng = np.random.default_rng(seed + 16)
    calls = [((8, 8, None), 128, 2 * SR, False, (3, 0, 0, 0)),
             ((2, 2, None), 128, 2 * SR, False, (3, 0, 0, 0)),
             ((8, 8, None), 4, 163840, True, (2, 1, 0, 1)),
             ((8, 8, 64), 4, 196608, True, (2, 0, 1, 1))]
    for (nh, G, mtc), B, T, bucketed, expect in calls:
        enhancer = seeded_enhancer(torch, seed, nh, G, mtc)
        enhance = make_enhance(enhancer)
        if bucketed:
            wave, lens = bucket_batch(np, rng, T, B)
            ln = torch.from_numpy(lens).cuda()
        else:
            wave = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
            ln = None
        x = torch.from_numpy(wave).cuda()
        enhance(x) if ln is None else enhance(x, ln)  # warm-up
        out, got = run_counted(torch, enhance, x, ln, dict(zip(
            ("fused_ftf_block", "fused_mhsa", "banded_mhsa",
             "fused_grouped_gru"), expect)))
        for k in launches:
            launches[k] += got[k]
        if not torch.isfinite(out).all() or tuple(out.shape) != (B, T):
            raise AssertionError(f"widths enhancer output bad: "
                                 f"{tuple(out.shape)}")
        with torch.inference_mode():
            mask = enhancer(x, ln)[1]
            with plain_route(torch):
                ref_wave, ref_mask = enhancer(x, ln)
        werr = (out - ref_wave).abs().max().item()
        merr = (mask - ref_mask).abs().max().item()
        if not (werr <= TOL_WAVE and merr <= TOL_MASK):
            raise AssertionError(
                f"widths enhancer heads={nh} groups={G} B={B} x {T}: wave "
                f"{werr} (tol {TOL_WAVE}), mask {merr} (tol {TOL_MASK}) "
                "against the plain path on the card")
        call = (lambda: enhance(x)) if ln is None else (lambda: enhance(x, ln))
        emit({"phase": "widths", "workload": f"B={B} x {T} samples" + (
                  " bucketed" if bucketed else ""),
              "num_heads": nh, "gru_groups": G, "max_time_context": mtc,
              "seed": seed, "launches": got,
              "wave_max_abs_err_vs_plain_on_card": werr,
              "mask_max_abs_err_vs_plain_on_card": merr,
              "tol_wave": TOL_WAVE, "tol_mask": TOL_MASK,
              "ms_per_call": cuda_ms(torch, call, 3), "device": card})
        del enhancer, enhance, x, ln, out, mask, ref_wave, ref_mask
        torch.cuda.empty_cache()
    emit({"phase": "widths", "kernel_cases_s": kernel_s,
          "seconds": time.perf_counter() - t0})
    return results, launches


# Bottleneck widths the kernels take besides 64: the multiples of 16 up to
# 128 with their own kernel width or padded to the next power of two
# (CHANNELS), and widths whose padded layout runs below the narrowest
# kernel or past the next power of two above C (ANY_CHANNELS: 8 at 16, 24
# at 32 in 3 heads of 8, 40 at 64, 50 at 128 in 5 heads or groups of 10,
# 80 at 128); those timed at the main path's shapes (4 heads, 4 groups).
CHANNELS = (16, 32, 48, 96, 128)
ANY_CHANNELS = (8, 24, 40, 50, 80)
MAIN_CHANNELS = (32, 40, 80, 128)
# Enhancer on the card against the plain path on the card, both bf16 mode:
# the worst row's relative L2 error of the wave. Both round the same
# operands; f32 sum order moves an intermediate across a bf16 rounding
# boundary now and then (the widths phase's enhancers: max |diff| of the
# wave within TOL_WAVE = 1e-2 of a ~0.1-scale wave), and a wiring fault is
# O(1).
TOL_REL_L2 = 1e-2


def channel_pairs(C):
    """(heads, groups) pairs at C that run every divisor of C as a head
    count and as a group count once: the divisors against themselves
    reversed (each pair one the card takes: ops/library.py::card_takes)."""
    from lct_gan_tpu_torch.ops.library import card_takes, divisors

    d = divisors(C)
    pairs = list(zip(d, reversed(d)))
    if not all(card_takes(C, nh, G) for nh, G in pairs):
        raise AssertionError(f"C = {C}: a pair the card does not take")
    return pairs


def host_pad_ms(torch, fn, reps=5):
    """Wall ms of one call of a wrapper's padding `fn` (its operands to the
    kernel width, device copies finished): what a width whose padded
    layout is not C pays before each launch."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def seeded_blocks(torch, seed, C, nh, G):
    """A frequency and a time FTF block of C channels with their modules'
    own random init under `seed`, on the card."""
    from lct_gan_tpu_torch.models.generator import (FreqGRUBlock,
                                                    TimeGRUBlock)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        f = FreqGRUBlock(channels=C, num_heads=nh, groups=G, precise=False)
        t = TimeGRUBlock(channels=C, num_heads=nh, groups=G, precise=False)
    return f.cuda().eval(), t.cuda().eval()


def worst_row_rel_l2(torch, out, ref):
    """max over rows of ||out - ref|| / ||ref|| (rows of [B, ...])."""
    d = (out - ref).flatten(1).norm(dim=1)
    return (d / ref.flatten(1).norm(dim=1).clamp_min(1e-30)).max().item()


def key_tail(torch, g, N, L, n_valid_min):
    """A [N, L] key bias of 0 on each row's first valid keys (a seeded
    count from n_valid_min to L) and -1e30 on the rest."""
    valid = torch.randint(n_valid_min, L + 1, (N,), generator=g,
                          device="cuda")
    pos = torch.arange(L, device="cuda")
    return torch.where(pos[None, :] < valid[:, None], 0.0,
                       -1e30).to(torch.float32)


def main_shape_cases(torch, g, seed, C, nh, G, exps_per_s, results, phase,
                     profile=False):
    """The four forward kernels at C channels in nh heads and G groups at
    the main path's shapes against their plain versions on the card, both
    modes (the composed GRU f32), timed beside the bound, the library call
    and the wrappers' padding ms (width_case); appended to
    results[kernel]. The padded products count the heads and slots the
    kernels run at the kernel width (CK, CA, CG: the block's, the
    attention's, the GRU's). With `profile`, the bf16 and GRU cases also
    carry `stages_ms` (device ms a call of each kernel the call launches,
    or None where the profiler lost kernels) and `stages_coverage`
    (stage_profile, one call a pass)."""

    def staged(fn, want, **info):
        if profile and want:  # one call a pass: these calls are long
            info.update(stage_profile(torch, fn, reps=1))
        return info

    from lct_gan_tpu_torch.ops.attention import (fused_mhsa, mhsa_reference,
                                                 pad_attention)
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block, kernel_operands)
    from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru,
                                           grouped_gru_plain, gru_slot,
                                           gru_kernel_operands, layer_norm)
    from lct_gan_tpu_torch.ops.padding import head_width, kernel_width

    def tail(N, L, n_valid_min):
        return key_tail(torch, g, N, L, n_valid_min)

    def head_flops(N, pairs, hd, CA):
        hdp = head_width(hd)
        return (N * (CA // hdp) * pairs * hd * 4,
                N * (CA // hdp) * pairs * 2 * (max(hdp, 16) + max(hdp, 8)))

    hd = C // nh
    CK = kernel_width(C, nh, G)
    CA, CG = kernel_width(C, num_heads=nh), kernel_width(C, groups=G)
    fblk, tblk = seeded_blocks(torch, seed + C, C, nh, G)
    for name, blk, N, L, lb in (("freq_main", fblk, 16512, 33, None),
                                ("time_keybias_lookback16_main", tblk,
                                 4224, 129, 16)):
        params = [p.detach().contiguous() for p in blk.kernel_params()]
        D = 2 if blk.bidirectional else 1
        x = torch.randn((N, L, C), generator=g, device="cuda")
        kb = tail(N, L, L - 40) if D == 1 else None
        rows, lin_in = N * L, params[12].shape[0]
        pairs_n = band_pairs(L, lb)
        attn, _ = head_flops(N, pairs_n, hd, C)
        _, attn_pad = head_flops(N, pairs_n, hd, CK)
        rest = rows * (2 * C * 3 * C + 2 * C * C + 2 * lin_in * C)
        rest_pad = rows * CK * CK * (6 + 2 + 2 * lin_in // C)
        gru = rows * 4 * D * 3 * C * (C // G)
        gru_pad = rows * 4 * D * 3 * CK * gru_slot(G, CK)
        extra = (sum(p.numel() for p in params) * 4
                 + (rows * 4 if kb is not None else 0))
        exps = N * nh * pairs_n + rows * D * C * 3
        pad_ms = host_pad_ms(torch, lambda: kernel_operands(
            [x, *params, kb], nh))
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=D == 2, num_heads=nh, lookback=lb,
                      precise=mode == "precise")

            def plain(lo, hi):
                return ftf_block_reference(
                    x[lo:hi], *params,
                    key_bias=None if kb is None else kb[lo:hi], **kw)

            def call():
                return fused_ftf_block(x, *params, key_bias=kb, **kw)

            res = width_case(
                torch, "fused_ftf_block", name, call,
                by_rows(torch, plain, N, 16 * nh * L * L + 64 * C * L),
                mode, (N, L), rest + gru + attn,
                rest_pad + gru_pad + attn_pad, extra, exps, exps_per_s,
                nh, G,
                lambda: library_or_reason(
                    torch, lambda: library_attention_ms(
                        torch, N, L, lb, kb, mode, nh, C)),
                C=C, phase=phase,
                info=staged(call, mode == "bf16", kernel_width=CK,
                            host_pad_ms=pad_ms))
            results["fused_ftf_block"].append(res)
        del x, kb
    aparams = [p.detach().contiguous()
               for p in tblk.attn.kernel_params()]
    for kernel, fn, ref, N, L, lb in (
            ("fused_mhsa", fused_mhsa, mhsa_reference, 825, 644, None),
            ("banded_mhsa", banded_mhsa, banded_mhsa_reference, 660, 772,
             64)):
        x = torch.randn((N, L, C), generator=g, device="cuda")
        kb = tail(N, L, L - 130)
        rows = N * L
        pairs_n = band_pairs(L, lb)
        attn, _ = head_flops(N, pairs_n, hd, C)
        _, attn_pad = head_flops(N, pairs_n, hd, CA)
        proj = rows * (2 * C * 3 * C + 2 * C * C)
        proj_pad = rows * 8 * CA * CA
        exps = (2 if lb is None else 1) * N * nh * pairs_n
        extra = sum(p.numel() for p in aparams) * 4 + rows * 4
        pad_ms = host_pad_ms(torch, lambda: pad_attention(
            [x, *aparams, kb], nh))
        for mode in ("bf16", "precise"):
            kw = dict(num_heads=nh, precise=mode == "precise")
            if lb is not None:
                kw["lookback"] = lb
                library = lambda: library_banded_ms(  # noqa: E731
                    torch, N, L, lb, mode, nh, C)
            else:
                library = lambda: library_or_reason(  # noqa: E731
                    torch, lambda: library_mha_ms(torch, x, aparams, kb,
                                                  mode, nh))

            def plain(lo, hi):
                return ref(x[lo:hi], *aparams, key_bias=kb[lo:hi], **kw)

            def call():
                return fn(x, *aparams, key_bias=kb, **kw)

            res = width_case(
                torch, kernel, f"L{L}_N{N}_keybias" + (
                    f"_W{lb}" if lb is not None else ""), call,
                by_rows(torch, plain, N, 16 * nh * L * L + 64 * C * L),
                mode, (N, L), proj + attn, proj_pad + attn_pad, extra,
                exps, exps_per_s, nh, G, library, C=C, phase=phase,
                info=staged(call, mode == "bf16", kernel_width=CA,
                            host_pad_ms=pad_ms))
            results[kernel].append(res)
        del x, kb
    gparams = [p.detach().contiguous() for p in tblk.kernel_params()[:6]]
    N, L = 825, 644
    x = torch.randn((N, L, C), generator=g, device="cuda")
    rows = N * L

    def gru_fn():
        return fused_grouped_gru(x, *gparams, bidirectional=False)

    def library():
        lib_ms, lib_out = library_gru(
            torch, layer_norm(x, *gparams[:2]), *gparams[2:])
        return lib_ms, None, (lib_out - gru_fn()).abs().max().item()

    pad_ms = host_pad_ms(torch, lambda: gru_kernel_operands(
        [x, *gparams]))
    res = width_case(
        torch, "fused_grouped_gru", f"L{L}", gru_fn,
        lambda: grouped_gru_plain(x, *gparams, False), "precise", (N, L),
        rows * 4 * 3 * C * (C // G),
        rows * 4 * 3 * CG * gru_kernel_slot(C, G),
        sum(p.numel() for p in gparams) * 4, rows * C * 3, exps_per_s,
        nh, G, library, C=C, phase=phase,
        info=staged(gru_fn, True, kernel_width=CG, host_pad_ms=pad_ms))
    results["fused_grouped_gru"].append(res)
    del x, fblk, tblk
    torch.cuda.empty_cache()


def check_channels(torch, np, card, seed):
    """The four forward kernels at every bottleneck width C of CHANNELS and
    ANY_CHANNELS (each padded by the wrappers to the kernel width of its
    layout): every head count and every GRU group count dividing C against
    the plain versions on the card at small N, both modes (the composed GRU
    f32); then at MAIN_CHANNELS (4 heads, 4 groups) the main path's shapes,
    timed, with the bound, the library call and the wrappers' padding ms;
    the enhancer end to end at enc_channels (8, 16, 32), (32, 64, 128),
    (16, 32, 40) and (16, 32, 50) at 5 heads and groups against the plain
    path on the card, with launch counts; training taken at (32, 64, 128)
    and (16, 32, 40) (train states), 48 and 50 (blocks under grad);
    serving and training taken (their layouts fit 256 channels) at (16,
    32, 100) in 5 heads and groups and at (16, 32, 144). Random
    weights from `seed`. Returns (kernel cases by kernel, launches by
    kernel)."""
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)
    from lct_gan_tpu_torch.ops.gru import fused_grouped_gru, grouped_gru_plain
    from lct_gan_tpu_torch.ops.library import KERNEL_WIDTHS
    from lct_gan_tpu_torch.ops.padding import kernel_width
    from lct_gan_tpu_torch.ops.probe import ex2_rate
    from lct_gan_tpu_torch.train.state import TrainConfig, build_models
    from lct_gan_tpu_torch.train.state import _assemble

    t0 = time.perf_counter()
    build_s = build_all(verbose=True, widths=KERNEL_WIDTHS)
    emit({"phase": "channels", "build_seconds": build_s,
          "kernel_widths": list(KERNEL_WIDTHS)})
    exps_per_s = ex2_rate()
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    results = {"fused_ftf_block": [], "fused_mhsa": [], "banded_mhsa": [],
               "fused_grouped_gru": []}

    def tail(N, L, n_valid_min):
        return key_tail(torch, g, N, L, n_valid_min)

    def small_case(*args):
        return small_kernel_case(torch, "channels", *args)

    # Every head count and group count of each width at small N.
    small = []
    n_cases = 0
    for C in CHANNELS + ANY_CHANNELS:
        worst = {}
        for nh, G in channel_pairs(C):
            fblk, tblk = seeded_blocks(torch, seed + C + nh, C, nh, G)
            cases = [("freq", fblk, 96, 33, False, None),
                     ("time_keybias", tblk, 32, 129, True, None),
                     ("time_lookback16", tblk, 32, 129, False, 16)]
            for name, blk, N, L, with_kb, lb in cases:
                params = [p.detach().contiguous()
                          for p in blk.kernel_params()]
                x = torch.randn((N, L, C), generator=g, device="cuda")
                kb = tail(N, L, L - 40) if with_kb else None
                for mode in ("bf16", "precise"):
                    kw = dict(bidirectional=blk.bidirectional, num_heads=nh,
                              lookback=lb, precise=mode == "precise")
                    small.append(small_case(
                        "fused_ftf_block", C, nh, G, name, mode,
                        lambda: fused_ftf_block(x, *params, key_bias=kb,
                                                **kw),
                        lambda: ftf_block_reference(x, *params, key_bias=kb,
                                                    **kw)))
            aparams = [p.detach().contiguous()
                       for p in tblk.attn.kernel_params()]
            for kernel, fn, ref, L, lb in (
                    ("fused_mhsa", fused_mhsa, mhsa_reference, 516, None),
                    ("banded_mhsa", banded_mhsa, banded_mhsa_reference, 772,
                     64)):
                x = torch.randn((6, L, C), generator=g, device="cuda")
                kb = tail(6, L, L - 130)
                for mode in ("bf16", "precise"):
                    kw = dict(num_heads=nh, precise=mode == "precise")
                    if lb is not None:
                        kw["lookback"] = lb
                    small.append(small_case(
                        kernel, C, nh, G, f"L{L}", mode,
                        lambda: fn(x, *aparams, key_bias=kb, **kw),
                        lambda: ref(x, *aparams, key_bias=kb, **kw)))
            gparams = [p.detach().contiguous()
                       for p in tblk.kernel_params()[:6]]
            x = torch.randn((6, 516, C), generator=g, device="cuda")
            small.append(small_case(
                "fused_grouped_gru", C, nh, G, "L516", "precise",
                lambda: fused_grouped_gru(x, *gparams, bidirectional=False),
                lambda: grouped_gru_plain(x, *gparams, False)))
            del fblk, tblk, x
        for r in small[n_cases:]:
            key = (r["kernel"], r["mode"])
            if r["max_abs_err"] >= worst.get(key, {}).get("max_abs_err", -1):
                worst[key] = r
        emit({"phase": "channels", "C": C,
              "kernel_width": {f"{nh},{G}": kernel_width(C, nh, G)
                               for nh, G in channel_pairs(C)},
              "pairs": channel_pairs(C), "cases": len(small) - n_cases,
              "worst": list(worst.values()), "tol": TOL})
        n_cases = len(small)
        torch.cuda.empty_cache()
    small_s = time.perf_counter() - t0

    # MAIN_CHANNELS at the main path's shapes, 4 heads and 4 groups.
    for C in MAIN_CHANNELS:
        main_shape_cases(torch, g, seed, C, 4, 4, exps_per_s, results,
                         "channels")
    main_s = time.perf_counter() - t0 - small_s

    # The enhancer end to end at other widths, each call against the plain
    # path on the card.
    launches = {k: 0 for k in ("fused_ftf_block", "fused_mhsa",
                               "banded_mhsa", "fused_ftf_bwd",
                               "fused_grouped_gru")}
    rng = np.random.default_rng(seed + 18)

    def enhancer_at(enc, mtc=None, nh=4, G=4):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + enc[-1])
            return LctEnhancer(gen_cfg=LCTGeneratorConfig(
                enc_channels=enc, dec_channels=enc[::-1], num_heads=nh,
                gru_groups=G, max_time_context=mtc)).cuda().eval()

    # (enc_channels, heads, groups): the serving batch (the fused path), a
    # bucketed call through the composed path and a banded W = 64 one.
    calls = [((8, 16, 32), 4, 4, None, 128, 2 * SR, False, (3, 0, 0, 0))]
    for enc, nh, G in (((32, 64, 128), 4, 4), ((16, 32, 40), 4, 4),
                       ((16, 32, 50), 5, 5)):
        calls += [(enc, nh, G, None, 128, 2 * SR, False, (3, 0, 0, 0)),
                  (enc, nh, G, None, 4, 163840, True, (2, 1, 0, 1)),
                  (enc, nh, G, 64, 4, 196608, True, (2, 0, 1, 1))]
    for enc, nh, G, mtc, B, T, bucketed, expect in calls:
        enhancer = enhancer_at(enc, mtc, nh, G)
        enhance = make_enhance(enhancer)
        if bucketed:
            wave, lens = bucket_batch(np, rng, T, B)
            ln = torch.from_numpy(lens).cuda()
        else:
            wave = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
            ln = None
        x = torch.from_numpy(wave).cuda()
        enhance(x) if ln is None else enhance(x, ln)  # warm-up
        out, got = run_counted(torch, enhance, x, ln, dict(zip(
            ("fused_ftf_block", "fused_mhsa", "banded_mhsa",
             "fused_grouped_gru"), expect)))
        for k in launches:
            launches[k] += got[k]
        if not torch.isfinite(out).all() or tuple(out.shape) != (B, T):
            raise AssertionError(f"channels enhancer output bad: "
                                 f"{tuple(out.shape)}")
        with torch.inference_mode():
            mask = enhancer(x, ln)[1]
            with plain_route(torch):
                ref_wave, ref_mask = enhancer(x, ln)
        rel = worst_row_rel_l2(torch, out, ref_wave)
        werr = (out - ref_wave).abs().max().item()
        merr = (mask - ref_mask).abs().max().item()
        if not (rel <= TOL_REL_L2 and werr <= TOL_WAVE and merr <= TOL_MASK):
            raise AssertionError(
                f"channels enhancer enc_channels={enc} B={B} x {T}: worst "
                f"row rel L2 {rel} (tol {TOL_REL_L2}), wave {werr} (tol "
                f"{TOL_WAVE}), mask {merr} (tol {TOL_MASK}) against the "
                "plain path on the card")
        call = (lambda: enhance(x)) if ln is None else (lambda: enhance(x, ln))
        emit({"phase": "channels", "workload": f"B={B} x {T} samples" + (
                  " bucketed" if bucketed else ""),
              "enc_channels": list(enc), "num_heads": nh, "gru_groups": G,
              "kernel_width": kernel_width(enc[-1], nh, G),
              "max_time_context": mtc, "seed": seed, "launches": got,
              "wave_worst_row_rel_l2_vs_plain_on_card": rel,
              "tol_rel_l2": TOL_REL_L2,
              "wave_max_abs_err_vs_plain_on_card": werr,
              "mask_max_abs_err_vs_plain_on_card": merr,
              "tol_wave": TOL_WAVE, "tol_mask": TOL_MASK,
              "ms_per_call": cuda_ms(torch, call, 3), "device": card})
        del enhancer, enhance, x, ln, out, mask, ref_wave, ref_mask
        torch.cuda.empty_cache()

    # Training at other widths is taken on the card (up to the backward's
    # widest kernel width, 512): train states at C = 128 and 40, blocks
    # under grad at C = 48 and 50 (5 heads and groups; their forward
    # launch: the backward runs in the train_channels phase), and serving
    # and train states at (16, 32, 100) at 5 heads and groups (a layout of
    # 160) and (16, 32, 144) (256), which the width256 phase runs (the
    # width512 phase refuses layouts past 512).
    accepted = []
    cfg = TrainConfig()
    _, mpd, msd = build_models(cfg)
    for enc in ((32, 64, 128), (16, 32, 40)):
        state = _assemble(cfg, enhancer_at(enc).cpu(), mpd, msd, "cuda")
        accepted.append(f"train state {enc}")
        del state
    for C, nh in ((48, 4), (50, 5)):
        blk = seeded_blocks(torch, seed, C, nh, nh)[0]
        params = [p.detach().clone().requires_grad_()
                  for p in blk.kernel_params()]
        fused_ftf_block.launches = 0
        out = fused_ftf_block(torch.randn((4, 33, C), device="cuda"),
                              *params, bidirectional=True, num_heads=nh)
        torch.cuda.synchronize()
        if not (fused_ftf_block.launches == 1 and out.requires_grad
                and torch.isfinite(out).all()):
            raise AssertionError(f"fused_ftf_block under grad at C = {C}: "
                                 f"{fused_ftf_block.launches} launches")
        accepted.append(f"fused_ftf_block under grad, C = {C}, {nh} heads "
                        f"and groups")
        del out, params, blk
    for enc, nh in (((16, 32, 100), 5), ((16, 32, 144), 4)):
        make_enhance(enhancer_at(enc, None, nh, nh))
        accepted.append(f"serve {enc}, {nh} heads and groups")
        state = _assemble(cfg, enhancer_at(enc, None, nh, nh).cpu(), mpd,
                          msd, "cuda")
        accepted.append(f"train state {enc}, {nh} heads and groups")
        del state
    emit({"phase": "channels", "accepted": accepted})
    emit({"phase": "channels", "small_cases": len(small),
          "small_cases_s": small_s, "main_cases_s": main_s,
          "build_seconds": build_s, "seconds": time.perf_counter() - t0})
    return results, launches


# Kernel width 256: at C = 256 (heads, groups) pairs that run each GRU slot
# width of the kernels (16, 32 packed into 64, 64, 128, the cluster's 256)
# and each padded head width (8 .. 256) once, the three padded layouts
# that run at 256, and the main path's pairs.
W256_PAIRS = ((1, 16), (2, 8), (4, 4), (8, 2), (16, 1), (32, 32), (64, 64))
W256_PADDED = ((100, 5, 5), (120, 3, 3), (144, 4, 4))
W256_MAIN = ((4, 4), (1, 1))
W256_ENC = (64, 128, 256)


def small_kernel_case(torch, phase, kernel, C, nh, G, name, mode, fn, plain):
    """One kernel call against its plain version on the same inputs on the
    card: raises unless max|diff| is within the kernel's tolerance and the
    output finite; returns the case's record."""
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    err = (out - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    tol = tol_of(kernel, mode)
    if not (err <= tol) or not torch.isfinite(out).all():
        raise AssertionError(f"{phase} {kernel} {name} C={C} heads={nh} "
                             f"groups={G} {mode}: max|diff| {err} > {tol}")
    return {"kernel": kernel, "case": name, "C": C, "num_heads": nh,
            "gru_groups": G, "mode": mode, "max_abs_err": err,
            "rel_err": rel}


def build_usage(width, source=None):
    """{kernel: registers and spill bytes} of kernel width `width`'s
    libraries (or of csrc/<source>.cu's alone) from this process's verbose
    build (ops/_build.py::BUILD_LOGS), demangled; empty where they were
    built before."""
    from lct_gan_tpu_torch.ops import _build
    from lct_gan_tpu_torch.ptxas_report import instance_names

    now = {}
    for (name, w), log in _build.BUILD_LOGS.items():
        if w == width and source in (None, name):
            now.update(_build.ptxas_usage(log))
    names = instance_names(now) if now else {}
    return {names[k]: v for k, v in now.items()}


def wide_cases(torch, np, card, seed, width, layouts, main_pairs, enc,
               seed_offset):
    """What the width256 and width512 phases share, at kernel width
    `width`: the build's ptxas counts of its instances (registers, spills,
    static shared memory); the four forward kernels against their plain
    versions on the card at small N, both modes (the composed GRU f32), at
    the (C, heads, groups) `layouts`; the main path's shapes at (width, nh,
    G) for `main_pairs`, timed beside the bound, the library call and the
    padding ms, with stages; the enhancer at enc_channels `enc` end to end
    against the plain path on the card, with launch counts and the peak of
    device memory: B = 128 x 2 s, one 163,840-sample bucket call and a W =
    64 banded call at 4 heads and groups, and the bucket call at 1 head and
    1 group (its composed GRU a single group of `width`). Random weights
    and inputs from `seed` + `seed_offset`. Returns (kernel cases by
    kernel, launches by kernel, seconds by step)."""
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)
    from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru,
                                           grouped_gru_plain, gru_slot)
    from lct_gan_tpu_torch.ops.padding import head_width, kernel_width
    from lct_gan_tpu_torch.ops.probe import ex2_rate

    phase = f"width{width}"
    build_s = build_all(verbose=True, widths=(width,))
    usage = build_usage(width)
    emit({"phase": phase, "build_seconds": build_s,
          "instances": len(usage),
          "spills": {k: v for k, v in usage.items()
                     if v.get("spill_stores") or v.get("spill_loads")},
          "registers": {k: v["registers"] for k, v in usage.items()},
          "smem": {k: v["smem"] for k, v in usage.items() if "smem" in v}})
    g = torch.Generator(device="cuda").manual_seed(seed + seed_offset)
    results = {"fused_ftf_block": [], "fused_mhsa": [], "banded_mhsa": [],
               "fused_grouped_gru": []}
    launches = {k: 0 for k in ("fused_ftf_block", "fused_mhsa",
                               "banded_mhsa", "fused_ftf_bwd",
                               "fused_grouped_gru")}
    seconds = {"build": build_s}

    t = time.perf_counter()
    small = []
    for C, nh, G in layouts:
        if kernel_width(C, nh, G) != width:
            raise AssertionError(f"({C}, {nh}, {G}) is not at width {width}")
        n0 = len(small)
        fblk, tblk = seeded_blocks(torch, seed + C + nh + G, C, nh, G)
        for name, blk, N, L, with_kb, lb in (
                ("freq", fblk, 24, 33, False, None),
                ("time_keybias", tblk, 8, 129, True, None),
                ("time_lookback16", tblk, 8, 129, False, 16)):
            params = [p.detach().contiguous()
                      for p in blk.kernel_params()]
            x = torch.randn((N, L, C), generator=g, device="cuda")
            kb = key_tail(torch, g, N, L, L - 40) if with_kb else None
            for mode in ("bf16", "precise"):
                kw = dict(bidirectional=blk.bidirectional, num_heads=nh,
                          lookback=lb, precise=mode == "precise")
                small.append(small_kernel_case(
                    torch, phase, "fused_ftf_block", C, nh, G, name, mode,
                    lambda: fused_ftf_block(x, *params, key_bias=kb,
                                            **kw),
                    lambda: ftf_block_reference(x, *params, key_bias=kb,
                                                **kw)))
        aparams = [p.detach().contiguous()
                   for p in tblk.attn.kernel_params()]
        for kernel, fn, ref, L, lb in (
                ("fused_mhsa", fused_mhsa, mhsa_reference, 516, None),
                ("banded_mhsa", banded_mhsa, banded_mhsa_reference, 772,
                 64)):
            x = torch.randn((3, L, C), generator=g, device="cuda")
            kb = key_tail(torch, g, 3, L, L - 130)
            for mode in ("bf16", "precise"):
                kw = dict(num_heads=nh, precise=mode == "precise")
                if lb is not None:
                    kw["lookback"] = lb
                small.append(small_kernel_case(
                    torch, phase, kernel, C, nh, G, f"L{L}", mode,
                    lambda: fn(x, *aparams, key_bias=kb, **kw),
                    lambda: ref(x, *aparams, key_bias=kb, **kw)))
        gparams = [p.detach().contiguous()
                   for p in tblk.kernel_params()[:6]]
        x = torch.randn((5, 516, C), generator=g, device="cuda")
        small.append(small_kernel_case(
            torch, phase, "fused_grouped_gru", C, nh, G, "L516", "precise",
            lambda: fused_grouped_gru(x, *gparams, bidirectional=False),
            lambda: grouped_gru_plain(x, *gparams, False)))
        worst = {}
        for r in small[n0:]:
            key = f"{r['kernel']} {r['mode']}"
            if r["max_abs_err"] >= worst.get(key, {}).get(
                    "max_abs_err", -1):
                worst[key] = r
        emit({"phase": phase, "C": C, "num_heads": nh, "gru_groups": G,
              "kernel_width": kernel_width(C, nh, G),
              "ftf_gru_slot": gru_slot(width // head_width(C // G), width),
              "head_width": head_width(C // nh),
              "cases": len(small) - n0,
              "worst": {k: (v["max_abs_err"], v["rel_err"])
                        for k, v in worst.items()}, "tol": TOL,
              "tol_gru": TOL_GRU})
        del fblk, tblk, x
        torch.cuda.empty_cache()
    seconds["small"] = time.perf_counter() - t
    emit({"phase": phase, "small_cases": len(small),
          "seconds": seconds["small"]})

    t = time.perf_counter()
    exps_per_s = ex2_rate()
    for nh, G in main_pairs:
        main_shape_cases(torch, g, seed, width, nh, G, exps_per_s, results,
                         phase, profile=True)
    seconds["main"] = time.perf_counter() - t

    t = time.perf_counter()
    rng = np.random.default_rng(seed + seed_offset)
    # (heads, groups, max_time_context, B, T, bucketed, launches: FTF,
    # MHSA, banded, composed GRU)
    calls = [(4, 4, None, 128, 2 * SR, False, (3, 0, 0, 0)),
             (4, 4, None, 4, 163840, True, (2, 1, 0, 1)),
             (4, 4, 64, 4, 196608, True, (2, 0, 1, 1)),
             (1, 1, None, 4, 163840, True, (2, 1, 0, 1))]
    for nh, G, mtc, B, T, bucketed, expect in calls:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + width + nh)
            enhancer = LctEnhancer(gen_cfg=LCTGeneratorConfig(
                enc_channels=enc, dec_channels=enc[::-1], num_heads=nh,
                gru_groups=G, max_time_context=mtc)).cuda().eval()
        enhance = make_enhance(enhancer)
        if bucketed:
            wave, lens = bucket_batch(np, rng, T, B)
            ln = torch.from_numpy(lens).cuda()
        else:
            wave = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
            ln = None
        x = torch.from_numpy(wave).cuda()
        torch.cuda.reset_peak_memory_stats()
        out, got = run_counted(torch, enhance, x, ln, dict(zip(
            ("fused_ftf_block", "fused_mhsa", "banded_mhsa",
             "fused_grouped_gru"), expect)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k in launches:
            launches[k] += got[k]
        if not torch.isfinite(out).all() or tuple(out.shape) != (B, T):
            raise AssertionError(f"{phase} enhancer output bad: "
                                 f"{tuple(out.shape)}")
        with torch.inference_mode():
            mask = enhancer(x, ln)[1]
            with plain_route(torch):
                ref_wave, ref_mask = enhancer(x, ln)
        rel = worst_row_rel_l2(torch, out, ref_wave)
        werr = (out - ref_wave).abs().max().item()
        merr = (mask - ref_mask).abs().max().item()
        if not (rel <= TOL_REL_L2 and werr <= TOL_WAVE
                and merr <= TOL_MASK):
            raise AssertionError(
                f"{phase} enhancer {nh} heads {G} groups B={B} x {T}: "
                f"worst row rel L2 {rel} (tol {TOL_REL_L2}), wave {werr} "
                f"(tol {TOL_WAVE}), mask {merr} (tol {TOL_MASK}) against "
                "the plain path on the card")
        call = ((lambda: enhance(x)) if ln is None
                else (lambda: enhance(x, ln)))
        emit({"phase": phase, "workload": f"B={B} x {T} samples" + (
                  " bucketed" if bucketed else ""),
              "enc_channels": list(enc), "num_heads": nh, "gru_groups": G,
              "kernel_width": width, "max_time_context": mtc, "seed": seed,
              "launches": got,
              "wave_worst_row_rel_l2_vs_plain_on_card": rel,
              "tol_rel_l2": TOL_REL_L2,
              "wave_max_abs_err_vs_plain_on_card": werr,
              "mask_max_abs_err_vs_plain_on_card": merr,
              "tol_wave": TOL_WAVE, "tol_mask": TOL_MASK,
              "ms_per_call": cuda_ms(torch, call, 1),
              "peak_gib_counted_call": peak, "device": card})
        del enhancer, enhance, x, ln, out, mask, ref_wave, ref_mask
        torch.cuda.empty_cache()
    seconds["enhance"] = time.perf_counter() - t
    return results, launches, seconds


def check_width256(torch, np, card, seed):
    """Serving at kernel width 256 (bottleneck layouts of 129 to 256
    channels, `wide_cases`): C = 256 in W256_PAIRS (every GRU slot width,
    the group of 256 through the thread-block-cluster kernel, and every
    head width) and the padded layouts W256_PADDED at small N, the main
    path's shapes at W256_MAIN, the enhancer at W256_ENC; last, training at
    kernel width 256 taken (a train state at W256_ENC, the FTF block under
    grad with its forward and backward launches) and serving and a train
    state at (64, 128, 272) (kernel width 512; no launch). Random weights
    from `seed`. Returns (kernel cases by kernel, launches by kernel)."""
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
    from lct_gan_tpu_torch.train.state import (TrainConfig, _assemble,
                                               build_models)

    t0 = time.perf_counter()
    results, launches, seconds = wide_cases(
        torch, np, card, seed, 256,
        [(256, nh, G) for nh, G in W256_PAIRS] + list(W256_PADDED),
        W256_MAIN, W256_ENC, 22)

    # Taken at kernel width 256: a train state at W256_ENC (assembling
    # launches nothing) and the FTF block under grad at C = 256 (one
    # forward and one backward launch, finite gradients).
    cfg = TrainConfig()
    _, mpd, msd = build_models(cfg)
    enc_cfg = LCTGeneratorConfig(enc_channels=W256_ENC,
                                 dec_channels=W256_ENC[::-1])
    fblk = seeded_blocks(torch, seed, 256, 4, 4)[0]
    params = [p.detach().clone().requires_grad_()
              for p in fblk.kernel_params()]
    x = torch.randn((4, 33, 256), device="cuda")

    def under_grad():
        fused_ftf_block(x, *params, bidirectional=True,
                        num_heads=4).square().mean().backward()
        if not all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in params):
            raise AssertionError("width256 FTF block under grad: gradients "
                                 "missing or not finite")

    past = LCTGeneratorConfig(enc_channels=(64, 128, 272),
                              dec_channels=(272, 128, 64))
    taken = []
    for what, act, want in (
            ("train state (64, 128, 256)",
             lambda: _assemble(cfg, LctEnhancer(gen_cfg=enc_cfg), mpd,
                               msd, "cuda"), (0, 0)),
            ("fused_ftf_block under grad, C = 256", under_grad, (1, 1)),
            ("serve (64, 128, 272) (kernel width 512)",
             lambda: make_enhance(LctEnhancer(gen_cfg=past).cuda()),
             (0, 0)),
            ("train state (64, 128, 272) (kernel width 512)",
             lambda: _assemble(cfg, LctEnhancer(gen_cfg=past), mpd, msd,
                               "cuda"), (0, 0))):
        fused_ftf_block.launches = fused_ftf_bwd.launches = 0
        act()
        torch.cuda.synchronize()
        got = (fused_ftf_block.launches, fused_ftf_bwd.launches)
        if got != want:
            raise AssertionError(f"width256 {what}: FTF forward / backward "
                                 f"launches {got}, expected {want}")
        taken.append({"what": what, "fused_ftf_block": got[0],
                      "fused_ftf_bwd": got[1]})
    emit({"phase": "width256", "taken": taken})
    del fblk, params, x
    torch.cuda.empty_cache()

    emit({"phase": "width256", "seconds": time.perf_counter() - t0,
          "steps_s": seconds})
    return results, launches


def refuse_by_name(torch, phase, cases):
    """Each (what, act, names) of `cases`: `act()` raises a ValueError
    whose message holds every one of `names`, before any FTF forward or
    backward launch; emitted as the phase's `refused` line."""
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

    refused = []
    for what, act, names in cases:
        fused_ftf_block.launches = fused_ftf_bwd.launches = 0
        try:
            act()
        except ValueError as exc:
            if not all(n in str(exc) for n in names):
                raise
            refused.append((what, str(exc)))
        else:
            raise AssertionError(f"{what} was taken on the card")
        torch.cuda.synchronize()
        if fused_ftf_block.launches or fused_ftf_bwd.launches:
            raise AssertionError(f"{what}: a launch before the refusal")
    emit({"phase": phase, "refused": refused})


# Kernel width 512: at C = 512 (heads, groups) pairs that run each GRU slot
# width of the kernels (16: groups of 16 at (1, 32) and of 8 at (64, 64);
# 64, 128, the clusters' 256 and the step kernel's 512) and each padded
# head width (8 .. 512) once, the three padded layouts that run at 512, and
# the main path's pairs.
W512_PAIRS = ((1, 1), (2, 2), (4, 4), (8, 8), (1, 32), (64, 64))
W512_PADDED = ((272, 1, 1), (300, 3, 3), (320, 5, 5))
W512_MAIN = ((4, 4), (1, 1))
W512_ENC = (128, 256, 512)


def check_width512(torch, np, card, seed):
    """Serving at kernel width 512 (bottleneck layouts of 257 to 512
    channels, `wide_cases`): C = 512 in W512_PAIRS (every GRU slot width,
    the groups of 256 through the thread-block-cluster kernel, the group of
    512 through the step kernel, and every head width, 512 in four context
    parts) and the padded layouts W512_PADDED at small N, the main path's
    shapes at W512_MAIN, the enhancer at W512_ENC; then taken: a train
    state at W512_ENC (assembling launches nothing) and the FTF block
    under grad at C = 512 (one forward and one backward launch, finite
    gradients); last, refused by name before any launch: a train state
    and serving at (64, 128, 520) (a layout of 1,024) and serving at (400,
    5, 5) (heads of 80: a layout of 640). Random weights from `seed`.
    Returns (kernel cases by kernel, launches by kernel)."""
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
    from lct_gan_tpu_torch.train.state import (TrainConfig, _assemble,
                                               build_models)

    t0 = time.perf_counter()
    results, launches, seconds = wide_cases(
        torch, np, card, seed, 512,
        [(512, nh, G) for nh, G in W512_PAIRS] + list(W512_PADDED),
        W512_MAIN, W512_ENC, 24)

    cfg = TrainConfig()
    _, mpd, msd = build_models(cfg)

    def gen(enc, nh):
        return LctEnhancer(gen_cfg=LCTGeneratorConfig(
            enc_channels=enc, dec_channels=enc[::-1], num_heads=nh,
            gru_groups=nh))

    fblk = seeded_blocks(torch, seed, 512, 4, 4)[0]
    params = [p.detach().clone().requires_grad_()
              for p in fblk.kernel_params()]
    x = torch.randn((4, 33, 512), device="cuda")

    def under_grad():
        fused_ftf_block(x, *params, bidirectional=True,
                        num_heads=4).square().mean().backward()
        if not all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in params):
            raise AssertionError("width512 FTF block under grad: gradients "
                                 "missing or not finite")

    taken = []
    for what, act, want in (
            ("train state (128, 256, 512)",
             lambda: _assemble(cfg, gen(W512_ENC, 4), mpd, msd, "cuda"),
             (0, 0)),
            ("fused_ftf_block under grad, C = 512", under_grad, (1, 1))):
        fused_ftf_block.launches = fused_ftf_bwd.launches = 0
        act()
        torch.cuda.synchronize()
        got = (fused_ftf_block.launches, fused_ftf_bwd.launches)
        if got != want:
            raise AssertionError(f"width512 {what}: FTF forward / backward "
                                 f"launches {got}, expected {want}")
        taken.append({"what": what, "fused_ftf_block": got[0],
                      "fused_ftf_bwd": got[1]})
    emit({"phase": "width512", "taken": taken})
    del fblk, params, x
    refuse_by_name(torch, "width512", [
        ("train state (64, 128, 520)",
         lambda: _assemble(cfg, gen((64, 128, 520), 4), mpd, msd, "cuda"),
         ("enc_channels[-1]=520", "fits 512 channels",
          "needs 1024 channels")),
        ("serve (64, 128, 520)",
         lambda: make_enhance(gen((64, 128, 520), 4).cuda()),
         ("enc_channels[-1]=520", "fits 512 channels",
          "needs 1024 channels")),
        ("serve (64, 128, 400), 5 heads and groups",
         lambda: make_enhance(gen((64, 128, 400), 5).cuda()),
         ("enc_channels[-1]=400", "--num_heads 5", "fits 512 channels",
          "needs 640 channels"))])
    torch.cuda.empty_cache()

    emit({"phase": "width512", "seconds": time.perf_counter() - t0,
          "steps_s": seconds})
    return results, launches

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
    from lct_gan_tpu_torch.ops.gru import fused_grouped_gru

    enhancer = load_enhancer(CHECKPOINT, device="cuda", max_time_context=64)
    gru = [p.detach() for p in enhancer.gen.GRUt1.kernel_params()[:6]]
    cpu_enhancer = load_enhancer(CHECKPOINT, device="cpu",
                                 max_time_context=64)
    enhance = make_enhance(enhancer)
    names = ("fused_ftf_block", "fused_mhsa", "banded_mhsa",
             "fused_grouped_gru")
    launches = {k: 0 for k in names}
    rng = np.random.default_rng(2)
    for T, rows_checked, expect in (
            (196608, 2, (2, 0, 1, 1)),
            (917504, 1, (2, 0, 1, 1)),
            # routing boundary: S = 644 < 769 stays on the MHSA kernel
            (163840, 1, (2, 1, 0, 1))):
        B = 128 * 32000 // T
        wave, lens = bucket_batch(np, rng, T, B)
        x = torch.from_numpy(wave).cuda()
        ln = torch.from_numpy(lens).cuda()
        enhance(x, ln)  # warm-up
        out, got = run_counted(torch, enhance, x, ln,
                               dict(zip(names, expect)))
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
        # The composed time block's LN1 + GRU operator alone, at this
        # call's time-block shape, under the same inference mode as the call.
        S = T // 256 + 4
        h = torch.randn((B * 33, S, 64), device="cuda")
        with torch.inference_mode():
            gru_ms = cuda_ms(torch, lambda: fused_grouped_gru(
                h, *gru, bidirectional=False), 3)
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


# The train_widths phase's step against the plain path on the card, the
# same state and batch.
#   Losses, relative: precise, sum order only (as TOL_LOSS); bf16, a sum
#   order that moves a rounded operand by one bf16 ulp in a few elements
#   of a mean over thousands.
#   The step's gradients, read back as AdamW's first moment: in precise
#   mode each tensor's correlation with the plain step's above
#   MIN_GRAD_CORR, as the train phase holds the card against the CPU.
#   The parameter changes, in precise mode: at most TOL_STEP_OFF_SHARE of
#   all elements may move by more than TOL_STEP_OFF_LR * lr from the plain
#   step's change. AdamW's first step is lr * g / (|g| + eps), so f32 noise
#   in a gradient within ~eps of 0 moves that element by up to 2 lr (found:
#   one GRU bias element of 24 at 0.19 lr); a wiring fault moves most of a
#   tensor.
#   Not held: the key third of each attention in-projection bias, on which
#   the loss does not depend (softmax ignores a shift shared by every key),
#   so its gradient is rounding noise in both paths.
#   bf16 mode holds the losses; its gradients and changes are read (both
#   paths round at the same places but sum in other orders, so a gradient
#   within bf16 noise of 0 may flip, and AdamW makes a flip a 2 lr change).
TOL_STEP_LOSS = {"precise": 1e-4, "bf16": 1e-3}
TOL_STEP_OFF_LR = 1e-2
TOL_STEP_OFF_SHARE = 1e-3
# Widths of the phase's steps and entry-point run.
TRAIN_WIDTHS = ((8, 8), (2, 2))


def named_state_params(state):
    """(name, parameter, its optimizer) of a GAN train state's models."""
    return [(f"{part}.{n}", p, opt) for part, mod, opt in (
        ("enhancer", state.enhancer, state.g_opt),
        ("mpd", state.mpd, state.d_opt), ("msd", state.msd, state.d_opt))
        for n, p in mod.named_parameters()]


def held_parts(name, t):
    """A tensor's held and unheld parts: (key, slice, held?); the key third
    of an attention in-projection bias is not held."""
    if not name.endswith("attn.in_proj_bias"):
        return [(name, slice(None), True)]
    E = t.shape[0] // 3
    return [(f"{name}.{c}", slice(j * E, (j + 1) * E), c != "k")
            for j, c in enumerate("qkv")]


def step_vs_plain(torch, cfg, step, state0, noisy, clean):
    """One step from copies of `state0` through the kernels and through
    `plain_route`; the readings the phase holds (see TOL_STEP_*)."""
    import copy

    a, b = copy.deepcopy(state0), copy.deepcopy(state0)
    before = {n: p.detach().clone() for n, p, _ in named_state_params(state0)}
    ma = {k: float(v) for k, v in step(a, noisy, clean).items()}
    with plain_route(torch):
        mb = {k: float(v) for k, v in step(b, noisy, clean).items()}
    pa = {n: (p, opt) for n, p, opt in named_state_params(a)}
    pb = {n: (p, opt) for n, p, opt in named_state_params(b)}
    corrs, unheld_corrs, change_rel = {}, {}, {}
    off, total, off_max = 0, 0, 0.0
    for n, p0 in before.items():
        (p_a, opt_a), (p_b, opt_b) = pa[n], pb[n]
        lr = cfg.lr_g if n.startswith("enhancer.") else cfg.lr_d
        ga = opt_a.state[p_a]["exp_avg"]
        gb = opt_b.state[p_b]["exp_avg"]
        d, dr = p_a.detach() - p0, p_b.detach() - p0
        for key, sl, held in held_parts(n, p0):
            c = corr(ga[sl], gb[sl])
            if not held:
                unheld_corrs[key] = c
                continue
            corrs[key] = c
            den = dr[sl].norm().item()
            change_rel[key] = (d[sl] - dr[sl]).norm().item() / den if den \
                else float((d[sl] - dr[sl]).norm().item() > 0)
            diff = (d[sl] - dr[sl]).abs() / lr
            off += int((diff > TOL_STEP_OFF_LR).sum())
            total += diff.numel()
            off_max = max(off_max, diff.max().item())
    del a, b
    worst_corr = min(corrs, key=corrs.get)
    worst_change = max(change_rel, key=change_rel.get)
    return {"loss_rel_err": {k: abs(ma[k] - mb[k]) / abs(mb[k]) for k in mb},
            "min_grad_corr": corrs[worst_corr],
            "min_grad_corr_tensor": worst_corr,
            "unheld_min_grad_corr": min(unheld_corrs.values()),
            "worst_change_rel_err": change_rel[worst_change],
            "worst_change_tensor": worst_change,
            "changes_off_share": off / total, "changes_off": off,
            "elements": total, "max_change_diff_in_lr": off_max,
            "tensors": len(corrs)}


def counted_steps_vs_plain(torch, np, what, cfg, step, state0, fresh, noisy,
                           clean, rng):
    """Three counted steps of the main path from a copy of `state0` (3 FTF
    forward and 3 backward launches a step, finite metrics), then one step
    against the same step on the plain path on the card in each mode (bf16
    from `state0`, precise from `fresh(True)`; losses within TOL_STEP_LOSS,
    precise also every tensor's change). Raises naming `what`; returns
    (launches, metrics of the three steps, the comparisons by mode)."""
    import copy

    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

    state = copy.deepcopy(state0)
    for fn in (fused_ftf_block, fused_ftf_bwd):
        fn.launches = 0
    history = []
    for _ in range(3):
        m = step(state, *train_batch(np, rng, cfg.batch_size))
        history.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    got = {"fused_ftf_block": fused_ftf_block.launches,
           "fused_ftf_bwd": fused_ftf_bwd.launches}
    if got != {"fused_ftf_block": 9, "fused_ftf_bwd": 9}:
        raise AssertionError(f"{what}: launches in 3 steps {got}, expected "
                             "9 and 9")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"{what}: metrics not finite: {history}")
    del state
    compared = {}
    for mode, st0 in (("bf16", state0), ("precise", fresh(True))):
        r = step_vs_plain(torch, cfg, step, st0, noisy, clean)
        compared[mode] = r
        rel = r["loss_rel_err"]
        if not max(rel.values()) <= TOL_STEP_LOSS[mode]:
            raise AssertionError(
                f"{what} {mode}: step losses vs the plain path on the card "
                f"{rel} > {TOL_STEP_LOSS[mode]}")
        if mode == "precise" and not (
                r["min_grad_corr"] > MIN_GRAD_CORR
                and r["changes_off_share"] <= TOL_STEP_OFF_SHARE):
            raise AssertionError(f"{what} precise: step vs the plain path on "
                                 f"the card: {r}")
    return got, history, compared


STEP_TOL = {"loss": TOL_STEP_LOSS, "grad_corr": MIN_GRAD_CORR,
            "off_lr": TOL_STEP_OFF_LR, "off_share": TOL_STEP_OFF_SHARE}


def check_train_widths(torch, np, card, seed):
    """Training at heads and GRU groups other than 4 and 4:
    (a) fused_ftf_bwd against ftf_bwd_reference at every (heads, groups)
        pair of the widths phase, both modes, the frequency block (L = 33)
        and the time block with lookback 16 (L = 129) at small N;
    (b) the B = 64 x 2 s training shapes (freq N = 8,256, L = 33; time N =
        2,112, L = 129) at heads 1, 2, 8 (padded head widths 64, 32, 8)
        with 4 groups and groups 1, 2, 8 with 4 heads, timed;
    (c) create_state + make_train_step at (8, 8) and (2, 2), seeded weights,
        B = 8 x 2 s: three counted steps with finite losses, two runs from
        one state bit-equal, one step against the same step on the plain
        path on the card (precise: losses and every tensor's change; bf16:
        losses);
    (d) `train_cli --num_heads 8 --gru_groups 8` for one epoch on the loop
        phase's synthetic corpus, in a subprocess.
    Returns (kernel case records, launches of the counted steps)."""
    import copy
    import shutil
    import subprocess
    import tempfile

    from lct_gan_tpu_torch.ops.probe import ex2_rate
    from lct_gan_tpu_torch.train import (TrainConfig, create_state,
                                         make_train_step,
                                         read_checkpoint_meta)

    t0 = time.perf_counter()
    exps_per_s = ex2_rate()

    def exp_floor_ms(n_exps):
        return n_exps / exps_per_s * 1e3

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    cases = []

    def run_case(nh, G, name, block, N, L, lookback, timed):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        for mode in ("bf16", "precise"):
            res = ftf_bwd_case(torch, f"widths {name} h{nh} g{G}", x, params,
                               D, lookback, mode, g, exp_floor_ms, nh, G,
                               timed)
            cases.append(res)
            emit({"phase": "train_widths", "kernel": "fused_ftf_bwd", **res})
        del x
        torch.cuda.empty_cache()

    # (a) every pair of the widths phase, small N.
    pairs = sorted({(nh, 4) for nh in WIDTHS} | {(4, G) for G in WIDTHS}
                   | {(2, 2), (8, 8)})
    for nh, G in pairs:
        gen = seeded_enhancer(torch, seed, nh, G).gen
        run_case(nh, G, "freq", gen.GRUf1, 256, 33, None, False)
        run_case(nh, G, "time_lookback16", gen.GRUt1, 64, 129, 16, False)
    small_s = time.perf_counter() - t0

    # (b) the B = 64 x 2 s training shapes.
    for nh, G in ((1, 4), (2, 4), (8, 4), (4, 1), (4, 2), (4, 8)):
        gen = seeded_enhancer(torch, seed, nh, G).gen
        run_case(nh, G, "freq", gen.GRUf1, 64 * 129, 33, None, True)
        run_case(nh, G, "time", gen.GRUt1, 64 * 33, 129, None, True)
    shapes_s = time.perf_counter() - t0 - small_s

    # (c) the train step at other widths.
    launches = {"fused_ftf_block": 0, "fused_ftf_bwd": 0}
    rng = np.random.default_rng(seed + 18)
    for nh, G in TRAIN_WIDTHS:
        cfg = TrainConfig(num_heads=nh, gru_groups=G)
        step = make_train_step(cfg)

        def fresh(precise):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                return create_state(cfg, torch.Generator().manual_seed(seed),
                                    device="cuda", precise=precise)

        state0 = fresh(False)
        gen = state0.enhancer.gen
        if (gen.cfg.num_heads, gen.cfg.gru_groups) != (nh, G):
            raise AssertionError(f"train_widths state widths {gen.cfg}")
        noisy, clean = train_batch(np, rng, cfg.batch_size)
        a, b = copy.deepcopy(state0), copy.deepcopy(state0)
        ma, mb = step(a, noisy, clean), step(b, noisy, clean)
        if not (all(torch.equal(ma[k], mb[k]) for k in ma) and all(
                torch.equal(p, q) for p, q in zip(
                    [*a.g_params(), *a.d_params()],
                    [*b.g_params(), *b.d_params()]))):
            raise AssertionError(f"train_widths ({nh}, {G}): two steps from "
                                 "one state differ")
        del a, b
        got, history, compared = counted_steps_vs_plain(
            torch, np, f"train_widths ({nh}, {G})", cfg, step, state0, fresh,
            noisy, clean, rng)
        for k in launches:
            launches[k] += got[k]
        emit({"phase": "train_widths", "check": "B=8 x 2 s steps",
              "num_heads": nh, "gru_groups": G, "seed": seed,
              "launches_3_steps": got, "two_runs_bit_equal": True,
              "metrics_3_steps": history, "vs_plain_on_card": compared,
              "tol": STEP_TOL, "device": card})
        del state0
        torch.cuda.empty_cache()
    steps_s = time.perf_counter() - t0 - small_s - shapes_s

    # (d) the entry point at 8 heads and 8 groups, one epoch.
    root = tempfile.mkdtemp(prefix="lct_train_widths_")
    try:
        data_root = os.path.join(root, "data")
        write_corpus(np, data_root)
        expr = os.path.join(root, "expr")
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lct_gan_tpu_torch.train_cli",
             "--data_root", data_root, "--expr_root", expr, "--epochs", "1",
             "--batch_size", "8", "--val_interval", "1", "--ckpt_interval",
             "1", "--log_interval", "1", "--no_pesq", "--num_heads", "8",
             "--gru_groups", "8", "--data_parallel", "1", "--device",
             "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"train_cli --num_heads 8 --gru_groups 8 "
                                 f"failed (rc {proc.returncode}):\n"
                                 f"{proc.stderr[-4000:]}")
        runs = os.listdir(expr)
        best = os.path.join(expr, runs[0], "ckpts", "best.pt")
        meta = read_checkpoint_meta(best)
        widths = (meta["train_cfg"]["num_heads"],
                  meta["train_cfg"]["gru_groups"])
        if len(runs) != 1 or widths != (8, 8):
            raise AssertionError(f"train_cli run {runs}, best.pt widths "
                                 f"{widths}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_widths", "check": "train_cli --num_heads 8 "
          "--gru_groups 8, 1 epoch", "rc": proc.returncode,
          "best_pt_widths": widths, "seconds": cli_s, "device": card})
    emit({"phase": "train_widths", "small_cases_s": small_s,
          "training_shapes_s": shapes_s, "steps_s": steps_s,
          "seconds": time.perf_counter() - t0})
    return cases, launches


# (heads, groups) pairs of the train_channels phase's small cases, each
# width's new code paths: attention by padded head width (8, 16, 32, 64,
# and 128 streamed), the GRU by slot (16, dense C <= 64, at C = 128 dense
# 64 on tensor cores and 128 on CUDA cores), the padded widths' zero heads
# and groups.
TRAIN_CHANNEL_PAIRS = {16: ((4, 4), (1, 1), (2, 8)),
                       32: ((4, 4), (1, 1), (32, 32)),
                       48: ((4, 4), (1, 1), (3, 3), (48, 2)),
                       96: ((4, 4), (1, 1), (2, 2), (32, 12)),
                       128: ((4, 4), (1, 1), (2, 8), (128, 128))}
# ANY_CHANNELS' widths take every head and group count (channel_pairs).
# The enhancers trained: (enc_channels, heads, groups).
TRAIN_CHANNEL_ENHANCERS = (((8, 16, 32), 4, 4), ((12, 24, 48), 4, 4),
                           ((32, 64, 128), 4, 4), ((16, 32, 40), 4, 4),
                           ((16, 32, 50), 5, 5))


def check_train_channels(torch, np, card, seed):
    """Training at bottleneck widths other than 64:
    (a) fused_ftf_bwd against ftf_bwd_reference at every C of CHANNELS,
        both modes, at the (heads, groups) pairs of TRAIN_CHANNEL_PAIRS,
        and at every C of ANY_CHANNELS at each of its channel_pairs, the
        frequency block (L = 33) and the time block with lookback 16 (L =
        129) at small N (the backward's libraries of every kernel width
        built first if they are not, in one parallel batch);
    (b) the B = 64 x 2 s training shapes (freq N = 8,256, L = 33; time N =
        2,112, L = 129) at MAIN_CHANNELS, 4 heads and 4 groups, timed with
        stages, scratch, plain and library (SDPA forward + backward) ms;
    (c) make_train_step on states assembled (`train/state.py::_assemble`)
        around enhancers at enc_channels TRAIN_CHANNEL_ENHANCERS with
        random weights from `seed`, B = 8 x 2 s: 3 FTF forward and 3
        backward launches a step over three counted steps, finite losses,
        one step against the plain path on the card (precise: losses and
        every tensor's change; bf16: losses);
    then kernel width 256, kept apart: (a) at C = 256 in W256_PAIRS and at
    W256_PADDED (frequency block N = 256, time block N = 64 with band 16),
    (b) the training shapes at W256_MAIN (also each case's peak GiB;
    precise timed once a case) and
    (c) the train step at enc_channels W256_ENC with each of W256_MAIN's
    (heads, groups);
    then kernel width 512 in the same way: (a) at C = 512 in W512_PAIRS and
    at W512_PADDED, (b) the saved hiddens of the forward under grad at
    W512_MAIN (`check_saved_hidden`) and the training shapes there
    (precise timed once a case: seconds a call), (c) the train step at
    W512_ENC with each of W512_MAIN's (heads, groups).
    Returns (kernel case records, launches of the counted steps, and the
    same two of kernel widths 256 and 512)."""
    from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                    LctEnhancer)
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.library import BACKWARD_WIDTHS
    from lct_gan_tpu_torch.ops.probe import ex2_rate
    from lct_gan_tpu_torch.train import TrainConfig, make_train_step
    from lct_gan_tpu_torch.train.state import _assemble, build_models

    t0 = time.perf_counter()
    build_s = build_all(verbose=True, widths=BACKWARD_WIDTHS, backward=True)
    emit({"phase": "train_channels", "backward_build_seconds": build_s,
          "kernel_widths": list(BACKWARD_WIDTHS), "device": card})
    exps_per_s = ex2_rate()

    def exp_floor_ms(n_exps):
        return n_exps / exps_per_s * 1e3

    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    cases, w256_cases, w512_cases = [], [], []

    def run_case(C, nh, G, name, block, N, L, lookback, timed, into=cases):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        D = 2 if block.bidirectional else 1
        x = torch.randn((N, L, C), generator=g, device="cuda")
        for mode in ("bf16", "precise"):
            torch.cuda.reset_peak_memory_stats()
            res = ftf_bwd_case(torch, f"channels {name} C{C} h{nh} g{G}", x,
                               params, D, lookback, mode, g, exp_floor_ms,
                               nh, G, timed)
            if timed:
                res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            into.append(res)
            emit({"phase": "train_channels", "kernel": "fused_ftf_bwd",
                  **res})
        del x
        torch.cuda.empty_cache()

    # (a) every width, small N.
    t1 = time.perf_counter()
    for C in CHANNELS + ANY_CHANNELS:
        for nh, G in TRAIN_CHANNEL_PAIRS.get(C) or channel_pairs(C):
            freq, tblk = seeded_blocks(torch, seed, C, nh, G)
            run_case(C, nh, G, "freq", freq, 256, 33, None, False)
            run_case(C, nh, G, "time_lookback16", tblk, 64, 129, 16, False)
            del freq, tblk
    small_s = time.perf_counter() - t1
    n_small = len(cases)

    # (b) the B = 64 x 2 s training shapes at MAIN_CHANNELS.
    t1 = time.perf_counter()
    for C in MAIN_CHANNELS:
        freq, tblk = seeded_blocks(torch, seed, C, 4, 4)
        run_case(C, 4, 4, "freq", freq, 64 * 129, 33, None, True)
        run_case(C, 4, 4, "time", tblk, 64 * 33, 129, None, True)
        del freq, tblk
    shapes_s = time.perf_counter() - t1

    # (c) the train step at other widths.
    t1 = time.perf_counter()
    cfg = TrainConfig()
    step = make_train_step(cfg)
    rng = np.random.default_rng(seed + 19)

    def train_steps(enc, nh, G, launches):
        def fresh(precise):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed + enc[-1])
                enhancer = LctEnhancer(
                    gen_cfg=LCTGeneratorConfig(enc_channels=enc,
                                               dec_channels=enc[::-1],
                                               num_heads=nh, gru_groups=G),
                    c=cfg.compress_c, precise=precise)
            _, mpd, msd = build_models(
                cfg, generator=torch.Generator().manual_seed(seed))
            return _assemble(cfg, enhancer, mpd, msd, "cuda")

        state0 = fresh(False)
        noisy, clean = train_batch(np, rng, cfg.batch_size)
        got, history, compared = counted_steps_vs_plain(
            torch, np, f"train_channels {enc}", cfg, step, state0, fresh,
            noisy, clean, rng)
        for k in launches:
            launches[k] += got[k]
        emit({"phase": "train_channels", "check": "B=8 x 2 s steps",
              "enc_channels": list(enc), "num_heads": nh, "gru_groups": G,
              "seed": seed, "launches_3_steps": got,
              "metrics_3_steps": history, "vs_plain_on_card": compared,
              "tol": STEP_TOL, "device": card})
        del state0
        torch.cuda.empty_cache()

    launches = {"fused_ftf_block": 0, "fused_ftf_bwd": 0}
    for enc, nh, G in TRAIN_CHANNEL_ENHANCERS:
        train_steps(enc, nh, G, launches)
    steps_s = time.perf_counter() - t1

    # Kernel width 256: (a) small N, (b) the training shapes, (c) steps.
    t1 = time.perf_counter()
    for C, nh, G in [(256, nh, G) for nh, G in W256_PAIRS] + list(
            W256_PADDED):
        freq, tblk = seeded_blocks(torch, seed, C, nh, G)
        run_case(C, nh, G, "freq", freq, 256, 33, None, False, w256_cases)
        run_case(C, nh, G, "time_lookback16", tblk, 64, 129, 16, False,
                 w256_cases)
        del freq, tblk
    w256_small_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for nh, G in W256_MAIN:
        freq, tblk = seeded_blocks(torch, seed, 256, nh, G)
        run_case(256, nh, G, "freq", freq, 64 * 129, 33, None, True,
                 w256_cases)
        run_case(256, nh, G, "time", tblk, 64 * 33, 129, None, True,
                 w256_cases)
        del freq, tblk
    w256_shapes_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    w256_launches = {"fused_ftf_block": 0, "fused_ftf_bwd": 0}
    for nh, G in W256_MAIN:
        train_steps(W256_ENC, nh, G, w256_launches)
    w256_steps_s = time.perf_counter() - t1

    # Kernel width 512: (a) small N, (b) the saved hiddens and the training
    # shapes, (c) steps.
    t1 = time.perf_counter()
    for C, nh, G in [(512, nh, G) for nh, G in W512_PAIRS] + list(
            W512_PADDED):
        freq, tblk = seeded_blocks(torch, seed, C, nh, G)
        run_case(C, nh, G, "freq", freq, 256, 33, None, False, w512_cases)
        run_case(C, nh, G, "time_lookback16", tblk, 64, 129, 16, False,
                 w512_cases)
        del freq, tblk
    walks = check_slot_walks(torch, seed, g)
    w512_small_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for nh, G in W512_MAIN:
        freq, tblk = seeded_blocks(torch, seed, 512, nh, G)
        for name, block, N, L, lookback in (
                ("freq", freq, 64, 33, None),
                ("time_lookback16", tblk, 16, 129, 16)):
            check_saved_hidden(
                torch, f"C512 h{nh} g{G} {name}",
                [p.detach().contiguous() for p in block.kernel_params()],
                N, L, lookback, g, nh, "train_channels")
        run_case(512, nh, G, "freq", freq, 64 * 129, 33, None, True,
                 w512_cases)
        run_case(512, nh, G, "time", tblk, 64 * 33, 129, None, True,
                 w512_cases)
        del freq, tblk
    w512_shapes_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    w512_launches = {"fused_ftf_block": 0, "fused_ftf_bwd": 0}
    for nh, G in W512_MAIN:
        train_steps(W512_ENC, nh, G, w512_launches)
    w512_steps_s = time.perf_counter() - t1
    emit({"phase": "train_channels", "backward_build_seconds": build_s,
          "small_cases": n_small,
          "small_cases_s": small_s, "training_shapes_s": shapes_s,
          "steps_s": steps_s, "width256_small_cases_s": w256_small_s,
          "width256_training_shapes_s": w256_shapes_s,
          "width256_steps_s": w256_steps_s,
          "width256_launches_steps": w256_launches,
          "width512_small_cases_s": w512_small_s,
          "width512_training_shapes_s": w512_shapes_s,
          "width512_steps_s": w512_steps_s,
          "width512_launches_steps": w512_launches,
          "width512_slot_walks": walks,
          "seconds": time.perf_counter() - t0})
    return (cases, launches, w256_cases, w256_launches, w512_cases,
            w512_launches)


def check_slot_walks(torch, seed, g):
    """At kernel width 512 one GRU group of 512 takes the step-synchronous
    walk (`bptt_step_kernel`, a launch a step) and two groups of 256 the
    cluster walk (`bptt_cluster_kernel`, one launch), in both modes: the
    walks' launches in one fused_ftf_bwd call at N = 5, L = 9 (frequency
    block), from the library's own counts (`csrc/ftf_bwd.cu`'s
    lct_ftf_backward_walk_launches, counted on the host at each launch).
    Returns {case: {walk: launches}}."""
    import ctypes

    from lct_gan_tpu_torch.ops import _build
    from lct_gan_tpu_torch.ops.ftf import ftf_forward_with_hidden
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

    count = _build.load_library("ftf_bwd", 512).lct_ftf_backward_walk_launches
    count.argtypes = [ctypes.c_int]
    count.restype = ctypes.c_longlong
    names = ("bptt_cluster_kernel", "bptt_step_kernel")
    walks = {}
    for nh, G, want in ((1, 1, (0, 9)), (2, 2, (1, 0))):
        freq = seeded_blocks(torch, seed, 512, nh, G)[0]
        params = [p.detach().contiguous() for p in freq.kernel_params()]
        x = torch.randn((5, 9, 512), generator=g, device="cuda")
        dout = torch.randn((5, 9, 512), generator=g, device="cuda")
        for mode in ("bf16", "precise"):
            kw = dict(bidirectional=True, num_heads=nh, lookback=None,
                      precise=mode == "precise")
            _, hid = ftf_forward_with_hidden(x, *params, **kw)
            before = [count(w) for w in (0, 1)]
            fused_ftf_bwd(x, *params, hid, dout, **kw)
            torch.cuda.synchronize()
            got = tuple(count(w) - before[w] for w in (0, 1))
            if got != want:
                raise AssertionError(
                    f"slot walk C=512 heads={nh} groups={G} {mode}: "
                    f"launches {dict(zip(names, got))}, expected "
                    f"{dict(zip(names, want))}")
            walks[f"C512 h{nh} g{G} {mode}"] = dict(zip(names, got))
        del freq, params, x, dout, hid
    emit({"phase": "train_channels", "check": "slot walks at 512",
          "launches": walks})
    return walks


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


PARALLEL_STEPS = 3


def check_parallel(torch, np, card):
    """Data parallelism on the card (parallel/mesh.py): the full-width GAN
    step over 2 ranks that share the card over gloo, against the 1-rank
    step; the tiny dry run; NCCL over 2 cards where there are 2."""
    from lct_gan_tpu_torch.parallel import spawn
    from lct_gan_tpu_torch.parallel.dryrun import (TOL, StateInit,
                                                   compare_step1, dryrun,
                                                   one_rank_steps,
                                                   rank_steps,
                                                   seeded_batches)
    from lct_gan_tpu_torch.train import TrainConfig

    cfg = TrainConfig()
    init = StateInit(seed=0, g_npz=CHECKPOINT)
    noisy, clean = seeded_batches(PARALLEL_STEPS, cfg.batch_size,
                                  cfg.segment_length, seed=11)
    expect = {"fused_ftf_block": 3, "fused_ftf_bwd": 3, "fused_mhsa": 0,
              "banded_mhsa": 0}

    def run(device, backend, steps):
        t0 = time.perf_counter()
        ranks = spawn(rank_steps, 2, device, backend, cfg, init,
                      noisy[:steps], clean[:steps])
        seconds = time.perf_counter() - t0
        for r in ranks:
            if r["backend"] != backend:
                raise AssertionError(f"rank {r['rank']} ran {r['backend']}")
            if r["launches"] != [expect] * steps:
                raise AssertionError(f"rank {r['rank']} launches "
                                     f"{r['launches']}, {expect} a step")
        return ranks, seconds

    # The counted run: 2 ranks on cuda:0, 3 steps of 4 rows each.
    ranks, seconds = run("cuda:0", "gloo", PARALLEL_STEPS)
    ref = one_rank_steps(cfg, init, noisy[:1], clean[:1], "cuda")
    cmp = compare_step1(ref, ranks, TOL["cuda"])
    launches = {k: sum(step[k] for r in ranks for step in r["launches"])
                for k in expect}
    emit({"phase": "parallel", "check": "2 ranks, gloo, one card shared, "
          "global B=8 x 2 s (4 rows a rank), TrainConfig(), 3 steps",
          "rank_devices": [r["device"] for r in ranks],
          "replicas_bit_equal_after_each_step": [r["replicas_equal"]
                                                for r in ranks],
          "launches_per_rank_per_step": ranks[0]["launches"][0],
          "vs_one_rank_step1": cmp, "metrics": ranks[0]["metrics"],
          "one_rank_metrics_step1": ref["metrics"][0],
          "one_rank_step_ms": ref["timing"][0]["step_ms"],
          "rank_step_ms": [[t["step_ms"] for t in r["timing"]]
                           for r in ranks],
          "rank_reduce_ms": [[t["reduce_ms"] for t in r["timing"]]
                             for r in ranks],
          "rank_d_reduce_ms": [[t["d_reduce_ms"] for t in r["timing"]]
                               for r in ranks],
          "rank_g_reduce_ms": [[t["g_reduce_ms"] for t in r["timing"]]
                               for r in ranks],
          "rank_wall_ms": [[t["wall_ms"] for t in r["timing"]]
                           for r in ranks],
          "spawn_to_results_s": seconds, "device": card})

    t0 = time.perf_counter()
    tiny = dryrun(2, "cuda:0", backend="gloo")
    emit({"phase": "parallel", "check": "parallel.dryrun: 2 ranks, gloo, "
          "TrainConfig(segment_seconds=0.25), B=4, precise kernels",
          "vs_one_rank_step1": tiny["compare"],
          "replicas_bit_equal": [r["replicas_equal"]
                                 for r in tiny["ranks"]],
          "launches_per_rank": [r["launches"] for r in tiny["ranks"]],
          "seconds": time.perf_counter() - t0})

    if torch.cuda.device_count() >= 2:
        # The gloo run's 3 steps, so that steps 2-3 compare with its own.
        nccl, seconds = run("cuda", "nccl", PARALLEL_STEPS)
        emit({"phase": "parallel", "check": "2 ranks, nccl, one card each",
              "rank_devices": [r["device"] for r in nccl],
              "replicas_bit_equal_after_each_step": [r["replicas_equal"]
                                                    for r in nccl],
              "vs_one_rank_step1": compare_step1(ref, nccl, TOL["cuda"]),
              **{f"rank_{k}": [[t[k] for t in r["timing"]] for r in nccl]
                 for k in ("step_ms", "reduce_ms", "d_reduce_ms",
                           "g_reduce_ms")},
              "spawn_to_results_s": seconds, "device": card})
    else:
        # A statement, not a pass: NCCL cannot put two ranks on one card.
        emit({"phase": "parallel", "nccl_2_rank": "not run: 1 card",
              "cards": torch.cuda.device_count()})
    return launches


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


def decode_ms(np, data_root):
    """Host ms per utterance of the native decoder and of its plain numpy
    version: the loop corpus's 2.5 s noisy train files (16 kHz PCM16), and
    one 2.5 s 48 kHz float file resampled to 16 kHz."""
    import statistics

    from lct_gan_tpu_torch.data import write_wav
    from lct_gan_tpu_torch.data.audio_io import (load_mono_wave,
                                                 load_mono_wave_numpy)

    folder = os.path.join(data_root, "noisy_train")
    corpus = [os.path.join(folder, n) for n in sorted(os.listdir(folder))]
    hi = os.path.join(data_root, "tone48k.wav")
    t = np.arange(int(2.5 * 48000)) / 48000
    write_wav(hi, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
              48000, bits=32)
    out = {}
    for label, paths in (("16k_pcm16", corpus), ("48k_f32_to_16k",
                                                 [hi] * 20)):
        for route, fn in (("native", load_mono_wave),
                          ("numpy", load_mono_wave_numpy)):
            fn(paths[0], SR)   # warm: the library is loaded, scipy imported
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                for path in paths:
                    fn(path, SR)
                runs.append((time.perf_counter() - t0) * 1e3 / len(paths))
            out[f"{label}_{route}_ms"] = statistics.median(runs)
    os.remove(hi)
    return out


def check_loop_parallel(torch, np, card, root, data_root):
    """train_cli --data_parallel 2 for one epoch on the loop corpus: one set
    of checkpoints, configs.json with the ranks and the backend, and
    validation equal to the 1-rank validation of the saved weights."""
    import csv

    from lct_gan_tpu_torch import train_cli
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import ScpDataset
    from lct_gan_tpu_torch.train import TrainConfig, make_eval_step, validate

    expr = os.path.join(root, "dp")
    t0 = time.perf_counter()
    out = train_cli.main(["--data_root", data_root, "--expr_root", expr,
                          "--epochs", "1", "--batch_size", "8",
                          "--val_interval", "1", "--ckpt_interval", "1",
                          "--log_interval", "1", "--no_pesq",
                          "--data_parallel", "2", "--device", "cuda"])
    seconds = time.perf_counter() - t0
    runs = os.listdir(expr)
    if len(runs) != 1:
        raise AssertionError(f"data-parallel run directories {runs}")
    run = os.path.join(expr, runs[0])
    names = sorted(os.listdir(os.path.join(run, "ckpts")))
    if names != ["best.pt", "epoch_0001.pt", "last.pt"]:
        raise AssertionError(f"data-parallel checkpoints {names}")
    with open(os.path.join(run, "configs.json")) as f:
        configs = json.load(f)
    want_backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    if (configs["devices"], configs["backend"]) != (2, want_backend):
        raise AssertionError(f"configs.json devices {configs['devices']} "
                             f"backend {configs['backend']}")
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 1:
        raise AssertionError(f"metrics.csv rows {rows}")
    cfg = TrainConfig(epochs=1)
    enh = load_enhancer(os.path.join(run, "ckpts", "best.pt"),
                        device="cuda")
    val_ds = ScpDataset(data_root, "test.scp", "test", sample_rate=SR,
                        segment_length=None, random_segment=False)
    one = validate(make_eval_step(cfg), enh, val_ds, cfg, cfg.batch_size,
                   compute_pesq=False, compute_stoi=True,
                   adaptive_target_seconds=cfg.val_target_batch_seconds)
    rel = {}
    for k in ("val_mrstft", "val_si_sdr", "val_stoi"):
        got = float(rows[0][k])
        rel[k] = abs(got - one[k]) / abs(one[k])
        if not abs(got - one[k]) <= 1e-5 + 2e-4 * abs(one[k]):
            raise AssertionError(f"2-rank validation {k} {got} vs 1-rank "
                                 f"{one[k]}")
    emit({"phase": "loop", "check": "train_cli --data_parallel 2, 1 epoch",
          "backend": configs["backend"], "devices": configs["devices"],
          "checkpoints": names, "steps": out["epochs"][0]["steps"],
          "rank0_step_ms": out["epochs"][0]["step_ms"],
          "val_rel_err_vs_one_rank": rel, "tol": {"rtol": 2e-4,
                                                  "atol": 1e-5},
          "val_metrics": {k: float(rows[0][k]) for k in rel},
          "seconds": seconds, "device": card})


def check_loop(torch, np, card, bare_step_ms):
    """The training run end to end at TrainConfig() defaults: a 2-epoch
    run, a 1-epoch run resumed to 2 (bit-equal), best.pt served by the
    infer CLI, the corpus decoded natively; then the same corpus trained
    on 2 ranks through the train CLI."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from lct_gan_tpu_torch import infer
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.data import load_mono_wave, read_wav
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.banded_attention import banded_mhsa
    from lct_gan_tpu_torch.ops.ftf import fused_ftf_block
    from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd
    from lct_gan_tpu_torch.ops.gru import fused_grouped_gru
    from lct_gan_tpu_torch.train import DataConfig, TrainConfig, run_training

    wrappers = (fused_ftf_block, fused_ftf_bwd, fused_mhsa, banded_mhsa,
                fused_grouped_gru)
    root = tempfile.mkdtemp(prefix="lct_loop_")
    try:
        data_root = os.path.join(root, "data")
        write_corpus(np, data_root)
        data = DataConfig(data_root=data_root)
        cfg = TrainConfig(epochs=2, val_interval=1, ckpt_interval=1)
        kw = dict(device="cuda", compute_pesq=False, compute_stoi=True)
        decode = decode_ms(np, data_root)
        emit({"phase": "loop", "decoder": "host ms per utterance (host "
              "CPU time, not device time)", **decode, "device": card})

        # The counted run: 2 epochs of the main path.
        for w in wrappers:
            w.launches = 0
        load_mono_wave.native_decodes = load_mono_wave.numpy_decodes = 0
        full = run_training(cfg, data, expr_root=os.path.join(root, "a"),
                            profile_steps=1, **kw)
        torch.cuda.synchronize()
        got = {w.__name__: w.launches for w in wrappers}
        decodes = {"native": load_mono_wave.native_decodes,
                   "numpy": load_mono_wave.numpy_decodes}
        if not (decodes["native"] > 0 and decodes["numpy"] == 0):
            raise AssertionError(f"loop corpus decodes {decodes}")
        steps = sum(e["steps"] for e in full["epochs"])
        per_epoch = LOOP_TRAIN // cfg.batch_size
        if [e["steps"] for e in full["epochs"]] != [per_epoch] * 2:
            raise AssertionError(f"steps per epoch {full['epochs']}")
        if not (got["fused_ftf_bwd"] == 3 * steps
                and got["fused_ftf_block"] > 3 * steps
                and got["fused_mhsa"] > 0 and got["banded_mhsa"] == 0
                # each composed validation call: one MHSA, one GRU
                and got["fused_grouped_gru"] == got["fused_mhsa"]):
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
              "decodes": decodes, "device": card})
        check_loop_parallel(torch, np, card, root, data_root)
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

    names = ("fused_ftf_block", "fused_mhsa", "banded_mhsa",
             "fused_grouped_gru")
    launches = {k: 0 for k in names}
    rng = np.random.default_rng(12)
    root = tempfile.mkdtemp(prefix="lct_export_")
    try:
        # keep_kernels artifacts: (shapes, max_time_context, expected
        # launches per call (FTF, MHSA, banded, GRU) for each shape).
        for label, shapes, mtc, expects in (
                ("kept", [(128, 32000), (4, 163840)], None,
                 [(3, 0, 0, 0), (2, 1, 0, 1)]),
                ("kept_banded64", [(4, 196608)], 64, [(2, 0, 1, 1)])):
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


ACCEPT_STAGES = {"2": "PASS", "3": "PASS", "4": "PASS", "1": "PASS",
                 "5": "PASS", "G": "SKIP"}


def check_accept(torch, np, card):
    """The driver entry point (entry.py) on the card against its CPU plain
    path, then the acceptance driver end to end in a subprocess."""
    import statistics
    import subprocess
    import tempfile

    from lct_gan_tpu_torch.convert import read_npz_params
    from lct_gan_tpu_torch.entry import entry

    params, _ = read_npz_params(CHECKPOINT)
    fn, (zeros,) = entry(params=params)
    cpu_fn, _ = entry(device="cpu", params=params)
    wave = (0.1 * np.random.default_rng(5).standard_normal(
        tuple(zeros.shape))).astype(np.float32)
    x = torch.from_numpy(wave).cuda()
    fn(x)  # warm-up
    out, got = run_counted(torch, fn, x, None,
                           {"fused_ftf_block": 3, "fused_mhsa": 0,
                            "banded_mhsa": 0})
    err = (out.cpu() - cpu_fn(torch.from_numpy(wave))).abs().max().item()
    if not err <= TOL_WAVE:
        raise AssertionError(f"entry() fn vs CPU plain path: {err} "
                             f"(tol {TOL_WAVE})")
    z = fn(zeros)
    if tuple(z.shape) != (8, 32000) or not torch.isfinite(z).all():
        raise AssertionError(f"entry() fn on its example: {tuple(z.shape)}")
    calls = [cuda_ms(torch, lambda: fn(x), 1) for _ in range(5)]
    emit({"phase": "accept", "check": "entry() fn, demo weights, "
          "(8, 32000) seeded 0.1 * N(0, 1)", "launches_per_call": got,
          "wave_max_abs_err_vs_cpu": err, "tol_wave": TOL_WAVE,
          "example_finite": True, "ms_per_call": calls,
          "median_ms": statistics.median(calls), "device": card})
    del fn, cpu_fn, out, z, x, zeros
    torch.cuda.empty_cache()

    # The parity gate G must SKIP: point LCT_REFERENCE_ROOT at a path that
    # does not exist, whatever the caller's environment holds.
    with tempfile.TemporaryDirectory(prefix="lct_accept_") as tmp:
        env = dict(os.environ,
                   LCT_REFERENCE_ROOT=os.path.join(tmp, "no-reference"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lct_gan_tpu_torch.acceptance",
             "--synthetic"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=900)
        seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        verdict = json.loads(lines[-1])
    except (IndexError, ValueError):
        verdict = None
    if proc.returncode != 0 or verdict != {"verdict": "PASS",
                                           "stages": ACCEPT_STAGES}:
        raise AssertionError(f"acceptance driver rc {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    emit({"phase": "accept", "check": "python -m lct_gan_tpu_torch."
          "acceptance --synthetic (device cuda)", "rc": proc.returncode,
          "stages": verdict["stages"], "wall_s": seconds,
          "table": [ln for ln in lines if ln.startswith("  [config")],
          "device": card})
    return got


def ptxas_c64():
    """The kernel width 64 instances' registers and spills from this run's
    verbose build (ops/_build.py::BUILD_LOGS) beside the reference's
    (PTXAS_REFERENCE, ptxas_report's JSON of the tree before the true width
    and the score scale became launch arguments): every instance, and
    those whose counts differ. Empty where the libraries were built before
    this run."""
    from lct_gan_tpu_torch.ops import _build

    now = build_usage(_build.DEFAULT_C)
    with open(PTXAS_REFERENCE, encoding="utf-8") as f:
        ref = json.load(f)["kernels"]

    def held(v):  # the counts the reference has (no shared memory)
        return v and {k: v[k] for k in ("registers", "spill_stores",
                                        "spill_loads") if k in v}

    changed = {k: {"reference": ref.get(k), "now": held(now.get(k))}
               for k in sorted(set(ref) | set(now))
               if held(ref.get(k)) != held(now.get(k))}
    spills = sorted(k for k, v in now.items()
                    if v["spill_stores"] and not (ref.get(k) or {}).get(
                        "spill_stores"))
    return {"ptxas_c64_instances": len(now),
            "ptxas_c64_reference_instances": len(ref),
            "ptxas_c64_changed": changed, "ptxas_c64_new_spills": spills,
            "ptxas_c64": now}


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the widths, channels and training-width "
                         "phases' random weights and inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA GPU visible")
    sys.path.insert(0, ROOT)
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.ops import _build
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.library import BACKWARD_WIDTHS, KERNEL_WIDTHS
    from lct_gan_tpu_torch.utils import (disable_tf32,
                                         gpu_name_and_power_limit)

    t_start = time.perf_counter()
    disable_tf32()
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # Kernel width 64's libraries (every source) and 128's forward ones
    # (the kernels phase's GRU chains run at 128) first, with the width 64
    # instances' registers and spills against the reference's; then every
    # other width's (up to 512) and the backward's (up to 512) in one
    # parallel batch in a background thread under the kernels, enhance and
    # widths phases (which launch nothing else), its nvcc processes at
    # niceness 19 so that they take no core those phases' host work wants.
    # The channels phase waits for it.
    build_s = build_all(verbose=True, widths=(64, 128))
    emit({"phase": "build", "seconds": build_s, "kernel_widths": [64, 128]})
    emit({"phase": "build", **ptxas_c64()})
    rest = {}

    def build_rest():
        try:
            rest["seconds"] = build_all(verbose=True, widths=KERNEL_WIDTHS,
                                        backward=BACKWARD_WIDTHS, nice=19)
        except Exception as exc:  # raised in the main thread at the join
            rest["error"] = exc

    build_thread = threading.Thread(target=build_rest)
    build_thread.start()

    enhancer = load_enhancer(CHECKPOINT, device="cuda")
    kernels = check_kernels(torch, enhancer)
    launches = check_enhance(torch, np, card, enhancer)
    del enhancer
    torch.cuda.empty_cache()
    width_cases, width_launches = check_widths(torch, np, card, args.seed)
    for k, rows in width_cases.items():
        kernels[k].extend(rows)
    for k, n in width_launches.items():
        launches[k] += n
    t = time.perf_counter()
    build_thread.join()
    if "error" in rest:
        raise rest["error"]
    emit({"phase": "build", "background_seconds": rest["seconds"],
          "waited_seconds": time.perf_counter() - t,
          "kernel_widths": list(KERNEL_WIDTHS),
          "backward_widths": list(BACKWARD_WIDTHS),
          "nvcc_seconds": {f"{n} C={c}": v for (n, c), v
                           in sorted(_build.BUILD_SECONDS.items())}})
    # The kernel width 512 backward's instances: registers, spills and
    # static shared memory (empty where it was built before this run).
    emit({"phase": "build", "ftf_bwd_c512_seconds":
          _build.BUILD_SECONDS.get(("ftf_bwd", 512)),
          "ftf_bwd_c512_ptxas": build_usage(512, "ftf_bwd")})
    channel_cases, channel_launches = check_channels(torch, np, card,
                                                     args.seed)
    for k, rows in channel_cases.items():
        kernels[k].extend(rows)
    for k, n in channel_launches.items():
        launches[k] += n
    # Kept apart: the kernels line's kernel width 256 entries read them.
    w256_cases, w256_launches = check_width256(torch, np, card, args.seed)
    for k, n in w256_launches.items():
        launches[k] += n
    # Kept apart: the kernels line's kernel width 512 entries read them.
    w512_cases, w512_launches = check_width512(torch, np, card, args.seed)
    for k, n in w512_launches.items():
        launches[k] += n
    for phase in (check_banded, check_stream):
        for k, n in phase(torch, np, card).items():
            launches[k] += n
    train_launches, state, step_ms = check_train(torch, np, card)
    for k, n in train_launches.items():
        launches[k] += n
    bwd_cases, step_launches = check_train_widths(torch, np, card,
                                                  args.seed)
    kernels["fused_ftf_bwd"].extend(bwd_cases)
    for k, n in step_launches.items():
        launches[k] += n
    # Kept apart as the width256 and width512 phases': the kernel width 256
    # and 512 backward's cases and their train steps' launches.
    (bwd_cases, step_launches, w256_cases["fused_ftf_bwd"], w256_steps,
     w512_cases["fused_ftf_bwd"], w512_steps) = check_train_channels(
        torch, np, card, args.seed)
    kernels["fused_ftf_bwd"].extend(bwd_cases)
    for k, n in step_launches.items():
        launches[k] += n
    check_eval(torch, np, card, state)
    del state
    torch.cuda.empty_cache()
    for k, n in check_parallel(torch, np, card).items():
        launches[k] += n
    for k, n in check_loop(torch, np, card, step_ms[8]).items():
        launches[k] += n
    for k, n in check_export(torch, np, card).items():
        launches[k] += n
    for k, n in check_accept(torch, np, card).items():
        launches[k] += n

    summary = []
    for name, src, replaces, head_L, head_mode in (
            ("fused_ftf_block", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/ftf.py:132", 33, "bf16"),
            ("fused_mhsa", "lct_gan_tpu_torch/csrc/mhsa.cu",
             "lct_gan_tpu/ops/attention.py:125", 644, "bf16"),
            ("banded_mhsa", "lct_gan_tpu_torch/csrc/banded.cu",
             "lct_gan_tpu/ops/banded_attention.py:109", 772, "bf16"),
            ("fused_ftf_bwd", "lct_gan_tpu_torch/csrc/ftf_bwd.cu",
             "lct_gan_tpu/ops/ftf_bwd.py:119", 33, "bf16"),
            # a lax.scan in the JAX package, not a Pallas kernel
            ("fused_grouped_gru", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/gru.py:28", 644, "precise")):
        head = next(r for r in kernels[name]
                    if r["L"] == head_L and r["mode"] == head_mode
                    and r.get("num_heads", 4) == 4
                    and r.get("gru_groups", 4) == 4 and r.get("C", 64) == 64)
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
                                    "scratch_bytes", "library_max_abs_err")
               if k in head},
            "case": f"{head['case']} {head['mode']}",
            "cases": kernels[name]})
    # The kernel width 256 instances (C = 256, 4 heads and groups, at the
    # main path's shapes), their launches from the width256 phase's
    # enhancer calls, the backward's from the train_channels phase's
    # steps at W256_ENC.
    w256_launches["fused_ftf_bwd"] = w256_steps["fused_ftf_bwd"]
    for name, src, replaces, head_L, head_mode in (
            ("fused_ftf_block", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/ftf.py:132", 33, "bf16"),
            ("fused_mhsa", "lct_gan_tpu_torch/csrc/mhsa.cu",
             "lct_gan_tpu/ops/attention.py:125", 644, "bf16"),
            ("banded_mhsa", "lct_gan_tpu_torch/csrc/banded.cu",
             "lct_gan_tpu/ops/banded_attention.py:109", 772, "bf16"),
            ("fused_grouped_gru", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/gru.py:28", 644, "precise"),
            ("fused_ftf_bwd", "lct_gan_tpu_torch/csrc/ftf_bwd.cu",
             "lct_gan_tpu/ops/ftf_bwd.py:119", 33, "bf16")):
        head = next(r for r in w256_cases[name]
                    if r["L"] == head_L and r["mode"] == head_mode
                    and r["num_heads"] == 4 and r["gru_groups"] == 4
                    and r.get("C", 256) == 256 and "plain_ms" in r)
        if w256_launches[name] <= 0:
            raise AssertionError(f"{name} was never launched at kernel "
                                 "width 256 on the path")
        summary.append({
            "name": f"{name} (kernel width 256)", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": w256_launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "case": f"{head['case']} {head['mode']}",
            "cases": w256_cases[name]})
    # The kernel width 512 instances (C = 512, 4 heads and groups, at the
    # main path's shapes), their launches from the width512 phase's
    # enhancer calls, the backward's from the train_channels phase's steps
    # at W512_ENC.
    w512_launches["fused_ftf_bwd"] = w512_steps["fused_ftf_bwd"]
    for name, src, replaces, head_L, head_mode in (
            ("fused_ftf_block", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/ftf.py:132", 33, "bf16"),
            ("fused_mhsa", "lct_gan_tpu_torch/csrc/mhsa.cu",
             "lct_gan_tpu/ops/attention.py:125", 644, "bf16"),
            ("banded_mhsa", "lct_gan_tpu_torch/csrc/banded.cu",
             "lct_gan_tpu/ops/banded_attention.py:109", 772, "bf16"),
            ("fused_grouped_gru", "lct_gan_tpu_torch/csrc/ftf.cu",
             "lct_gan_tpu/ops/gru.py:28", 644, "precise"),
            ("fused_ftf_bwd", "lct_gan_tpu_torch/csrc/ftf_bwd.cu",
             "lct_gan_tpu/ops/ftf_bwd.py:119", 33, "bf16")):
        head = next(r for r in w512_cases[name]
                    if r["L"] == head_L and r["mode"] == head_mode
                    and r["num_heads"] == 4 and r["gru_groups"] == 4
                    and r["C"] == 512 and "plain_ms" in r)
        if w512_launches[name] <= 0:
            raise AssertionError(f"{name} was never launched at kernel "
                                 "width 512 on the path")
        summary.append({
            "name": f"{name} (kernel width 512)", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": w512_launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "case": f"{head['case']} {head['mode']}",
            "cases": w512_cases[name]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "device": card})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

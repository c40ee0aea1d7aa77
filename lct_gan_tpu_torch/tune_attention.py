"""Time build-time variants of the bf16 attention kernel's work-item shape.

    python -m lct_gan_tpu_torch.tune_attention [--rounds 4] [--reps 10]

`csrc/tc.cuh` takes two choices of `attn_tc_kernel` as macros, separately
for the FTF block (MODE 0) and MHSA (MODE 1): the query rows of a work item
(16 per warp) and the blocks per SM its register budget is set for. This
script builds `csrc/ftf.cu` or `csrc/mhsa.cu` once per variant with -D
overrides of those macros (one nvcc per library, all started together, into
`build/`), then times the bf16 `fused_ftf_block` at the B = 128 x 2 s block
shapes and the bf16 `fused_mhsa` at the time blocks of the 131,072- and
163,840-sample buckets (chip_smoke.py's shapes, the committed demo weights)
under each variant against the committed defaults. Rounds alternate the
order of the variants; each round times `reps` calls with CUDA events. Every
variant's output is held against the plain version at bf16 mode's tolerance
(3e-2) before it is timed.

Prints one JSON line per case, then a summary line with the card's
`nvidia-smi` name and power limit and, per case, the median ms of each
variant. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from lct_gan_tpu_torch.ops import _build

# name -> (library, -D overrides of csrc/tc.cuh's macros)
VARIANTS = {
    "ftf_min_blocks1": ("ftf", {"LCT_FTF_ATTN_MIN_BLOCKS": 1}),
    "ftf_min_blocks2": ("ftf", {"LCT_FTF_ATTN_MIN_BLOCKS": 2}),
    "ftf_min_blocks4": ("ftf", {"LCT_FTF_ATTN_MIN_BLOCKS": 4}),
    "mhsa_rows128_min_blocks1": ("mhsa", {"LCT_MHSA_ATTN_MIN_BLOCKS": 1}),
    "mhsa_rows64_min_blocks2": ("mhsa", {"LCT_MHSA_ATTN_ROWS": 64,
                                         "LCT_MHSA_ATTN_MIN_BLOCKS": 2}),
    "mhsa_rows64_min_blocks3": ("mhsa", {"LCT_MHSA_ATTN_ROWS": 64,
                                         "LCT_MHSA_ATTN_MIN_BLOCKS": 3}),
    "mhsa_rows64_min_blocks4": ("mhsa", {"LCT_MHSA_ATTN_ROWS": 64,
                                         "LCT_MHSA_ATTN_MIN_BLOCKS": 4}),
}
DEFAULT = "default"
TOL_BF16 = 3e-2
CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "train_demo", "g_params_best.npz")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvcc_command(lib: str, defines: dict, path: str) -> list:
    """The nvcc command line of `lib` built with `defines` into `path`."""
    return [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
            *(f"-D{k}={v}" for k, v in sorted(defines.items())),
            "-o", path, os.path.join(_build.CSRC_DIR, f"{lib}.cu")]


def build_variants(variants: dict) -> dict:
    """name -> loaded library of each variant, built in parallel."""
    out_dir = os.path.join(_build.BUILD_DIR,
                           f"tune-{_build._source_hash()}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (lib, defines) in variants.items():
        path = os.path.join(out_dir, f"lib{lib}-{name}.so")
        if os.path.isfile(path):
            procs[name] = (path, None)
            continue
        procs[name] = (path, subprocess.Popen(
            nvcc_command(lib, defines, path + ".tmp"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        if proc is not None:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for variant {name}:\n"
                                   f"{err}{out}")
            os.replace(path + ".tmp", path)
        libs[name] = ctypes.CDLL(path)
    return libs


def cuda_ms(fn, reps: int) -> float:
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


def cases(gen, g):
    """(name, library, kernel call, plain call) at chip_smoke.py's shapes."""
    from lct_gan_tpu_torch.ops.attention import fused_mhsa, mhsa_reference
    from lct_gan_tpu_torch.ops.ftf import (ftf_block_reference,
                                           fused_ftf_block)

    def masked_tail(N, L, n_valid_min):
        valid = torch.randint(n_valid_min, L + 1, (N,), generator=g,
                              device="cuda")
        pos = torch.arange(L, device="cuda")
        return torch.where(pos[None, :] < valid[:, None], 0.0, -1e30)

    for name, block, N, L, use_kb, lookback in (
            ("ftf freq N=16512 L=33", gen.GRUf1, 128 * 129, 33, False, None),
            ("ftf time N=4224 L=129 key bias", gen.GRUt1, 128 * 33, 129,
             True, None),
            ("ftf time N=4224 L=129 lookback 16", gen.GRUt1, 128 * 33, 129,
             False, 16)):
        params = [p.detach().contiguous() for p in block.kernel_params()]
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kw = dict(bidirectional=block.bidirectional, num_heads=4,
                  lookback=lookback, precise=False,
                  key_bias=masked_tail(N, L, L - 40) if use_kb else None)
        yield (name, "ftf", lambda: fused_ftf_block(x, *params, **kw),
               lambda: ftf_block_reference(x, *params, **kw))
    aparams = [p.detach().contiguous()
               for p in gen.GRUt1.attn.kernel_params()]
    for B, L in ((31, 516), (25, 644)):
        N = B * 33
        x = torch.randn((N, L, 64), generator=g, device="cuda")
        kw = dict(num_heads=4, key_bias=masked_tail(N, L, L - 130),
                  precise=False)
        yield (f"mhsa N={N} L={L} key bias", "mhsa",
               lambda: fused_mhsa(x, *aparams, **kw),
               lambda: mhsa_reference(x, *aparams, **kw))


def run(rounds: int, reps: int, checkpoint: str) -> dict:
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.utils import (disable_tf32,
                                         gpu_name_and_power_limit)

    if not torch.cuda.is_available():
        raise RuntimeError("tune_attention times CUDA kernels: no GPU visible")
    disable_tf32()
    card = gpu_name_and_power_limit()
    _build.build_all()
    libs = build_variants(VARIANTS)
    gen = load_enhancer(checkpoint, device="cuda").gen
    g = torch.Generator(device="cuda").manual_seed(1234)
    summary = {}
    with torch.no_grad():
        for name, lib, call, plain in cases(gen, g):
            default_lib = _build.load_library(lib)
            key = (lib, _build.DEFAULT_C)  # the loaded library's slot
            names = [DEFAULT] + [v for v, (vl, _) in VARIANTS.items()
                                 if vl == lib]
            use = {DEFAULT: default_lib,
                   **{v: libs[v] for v in names if v != DEFAULT}}
            ref = plain()
            errs, times = {}, {v: [] for v in names}
            try:
                for v in names:
                    _build._libs[key] = use[v]
                    errs[v] = (call() - ref).abs().max().item()
                    if not errs[v] <= TOL_BF16:
                        raise AssertionError(f"{name} {v}: max|diff| "
                                             f"{errs[v]} > {TOL_BF16}")
                del ref
                torch.cuda.empty_cache()
                for r in range(rounds):
                    for v in (names if r % 2 == 0 else names[::-1]):
                        _build._libs[key] = use[v]
                        times[v].append(cuda_ms(call, reps))
            finally:
                _build._libs[key] = default_lib
            med = {v: sorted(t)[len(t) // 2] for v, t in times.items()}
            emit({"case": name, "max_abs_err": errs, "ms": times,
                  "median_ms": med, "device": card})
            summary[name] = med
            torch.cuda.empty_cache()
    return {"device": card, "rounds": rounds, "reps": reps,
            "variants": {v: d for v, (_, d) in VARIANTS.items()},
            "median_ms": summary,
            "fastest": {c: min(m, key=m.get) for c, m in summary.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    args = ap.parse_args(argv)
    emit(run(args.rounds, args.reps, args.checkpoint))
    return 0


if __name__ == "__main__":
    sys.exit(main())

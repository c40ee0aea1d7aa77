"""Where the bf16 banded kernel's error against its plain version comes from.

    python -m lct_gan_tpu_torch.banded_error [--variants]

Runs the bf16 `banded_mhsa` at chip_smoke.py's banded shapes (W = 64, the
time-block attention of the committed demo weights, key-masked tails) on
inputs made from seeds (one at S = 772, SEEDS at S = 3,588), and prints,
per library and input, the max and the mean of |kernel - plain| and the
count of outputs more than 1e-5 apart: the max is one element's tail, the
mean and the count follow a change of arithmetic. At S = 772 the MHSA
kernel under the same band (the port's other tensor-core design) runs too.
With --variants the fused kernel is also built (one nvcc each, in parallel,
into build/) with one of its arithmetic choices undone:

    div   p = bf16(e / l) by IEEE division, not bf16(e * (1 / l))
    expf  scores in natural units and expf, not log2 units and ex2.approx
    both  the two together

To compare another checkout's kernel on the same inputs, copy this file into
its package and run it there without --variants. Prints one JSON line per
(library, input) and a summary line with the card's nvidia-smi name and
power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from lct_gan_tpu_torch.ops import _build

# name -> (old, new, times old occurs) edits of csrc/banded.cu
VARIANTS = {
    "div": [("inv[hh][r] = tot > 0.f ? 1.f / tot : 0.f;",
             "inv[hh][r] = tot > 0.f ? tot : 1.f;", 1),
            (" * iv[", " / iv[", 8)],
    "expf": [("fmaf(sj[e], scale2,\n"
              "                             ((e & 1) ? kb[j].y : kb[j].x) "
              "* tc::LOG2E)",
              "fmaf(sj[e], inv_sqrt_hd(hd), (e & 1) ? kb[j].y : kb[j].x)",
              1),
             ("tc::ex2(sc[hh][c][j][e] - mx[hh][e >> 1])",
              "expf(sc[hh][c][j][e] - mx[hh][e >> 1])", 1)],
}
VARIANTS["both"] = VARIANTS["div"] + VARIANTS["expf"]
SEEDS = 4
CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "train_demo", "g_params_best.npz")


def variant_source(edits) -> str:
    """csrc/banded.cu with `edits` applied; raises if one no longer fits."""
    with open(os.path.join(_build.CSRC_DIR, "banded.cu"),
              encoding="utf-8") as f:
        src = f.read()
    for old, new, times in edits:
        if src.count(old) != times:
            raise ValueError(f"{old!r} occurs {src.count(old)} times in "
                             f"banded.cu, not {times}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """name -> loaded library of each variant, built in parallel."""
    out_dir = os.path.join(_build.BUILD_DIR,
                           f"banded-error-{_build._source_hash()}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src, lib = (os.path.join(out_dir, f"banded-{name}{ext}")
                    for ext in (".cu", ".so"))
        with open(src, "w", encoding="utf-8") as f:
            f.write(variant_source(edits))
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}{out}")
        libs[name] = ctypes.CDLL(lib)
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


def run(variants: bool, checkpoint: str) -> dict:
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.ops.attention import fused_mhsa
    from lct_gan_tpu_torch.ops.banded_attention import (banded_mhsa,
                                                        banded_mhsa_reference)
    from lct_gan_tpu_torch.utils import (disable_tf32,
                                         gpu_name_and_power_limit)

    disable_tf32()
    card = gpu_name_and_power_limit()
    _build.build_all()
    libs = {"committed": _build.load_library("banded"),
            **(build_variants() if variants else {})}
    attn = load_enhancer(checkpoint, device="cuda").gen.GRUt1.attn
    aparams = [p.detach().contiguous() for p in attn.kernel_params()]
    rows = []
    with torch.no_grad():
        for N, S, seed in ([(660, 772, 0)]
                           + [(132, 3588, s) for s in range(SEEDS)]):
            g = torch.Generator(device="cuda").manual_seed(1000 + seed)
            x = torch.randn((N, S, 64), generator=g, device="cuda")
            valid = torch.randint(S - 200, S + 1, (N,), generator=g,
                                  device="cuda")
            pos = torch.arange(S, device="cuda")
            kb = torch.where(pos[None, :] < valid[:, None], 0.0, -1e30)
            kw = dict(num_heads=4, lookback=64, key_bias=kb, precise=False)
            ref = banded_mhsa_reference(x, *aparams, **kw)
            calls = {}
            for name, lib in libs.items():
                def call(lib=lib):
                    _build._libs[("banded", _build.DEFAULT_C)] = lib
                    return banded_mhsa(x, *aparams, **kw)
                calls[name] = call
            if S <= 1024:
                calls["fused_mhsa"] = lambda: fused_mhsa(x, *aparams, **kw)
            for name, call in calls.items():
                d = (call() - ref).abs()
                row = {"library": name, "N": N, "S": S, "seed": seed,
                       "max_abs_err": d.max().item(),
                       "mean_abs_err": d.mean().item(),
                       "n_over_1e-5": int((d > 1e-5).sum()),
                       "ms": cuda_ms(call, 20) if seed == 0 else None}
                rows.append(row)
                print(json.dumps(row), flush=True)
                del d
            _build._libs[("banded", _build.DEFAULT_C)] = libs["committed"]
            del x, kb, ref
            torch.cuda.empty_cache()
    return {"device": card, "variants": sorted(libs), "rows": len(rows)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.variants, args.checkpoint)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

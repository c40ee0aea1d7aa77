"""Time one checkout's `fused_grouped_gru` on the card, to hold a change of
its kernel against the parent in one call:

    python3 tools/time_gru.py TREE LABEL [--runs 3] [--ftf]

TREE is the root of a checkout (e.g. a `git archive` of the parent); its
own `lct_gan_tpu_torch` and `chip_smoke.py` are imported, so run this file
by path, not with -m. One direction, all f32, at the composed time blocks
of the 131,072- and 163,840-sample buckets (N = 1,023 x L = 516, 825 x 644)
and the banded 917,504-sample call's (132 x 3,588), with the demo weights'
GRUt1; then seeded weights where the smoke times a cuDNN call beside the
kernel: one dense slot of 64 (1 and 2 groups, 33 x 516), C = 32 and C = 128
with 4 groups (825 x 644). Each case: max|diff| against
`grouped_gru_plain` on the card, `--runs` CUDA-event means of 5 launches,
and one cuDNN `torch.nn.GRU` call on the LN1 output with block-diagonal
weights (`chip_smoke.py::library_gru`). --ftf also times the FTF block
forward (`fused_ftf_block`, both modes) at the smoke's B = 128 x 2 s
shapes: frequency N = 16,512 x 33, time 4,224 x 129 with a key mask, and
with lookback 16. Prints one JSON line. Run the two trees in turns
(parent, change, change, parent), one process each.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree")
    parser.add_argument("label")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--ftf", action="store_true")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    # Run by path, this file's directory is sys.path[0]: the tree replaces
    # it, so the tree's package and chip_smoke.py are the ones imported.
    sys.path[0] = tree
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from lct_gan_tpu_torch.convert import load_enhancer
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.ops.gru import (fused_grouped_gru,
                                           grouped_gru_plain, layer_norm)
    from lct_gan_tpu_torch.utils import (disable_tf32,
                                         gpu_name_and_power_limit)

    disable_tf32()
    build_s = build_all(widths=(64, 32, 128))
    gen = load_enhancer(cs.CHECKPOINT, device="cuda").gen
    demo = [p.detach().contiguous() for p in gen.GRUt1.kernel_params()[:6]]
    g = torch.Generator(device="cuda").manual_seed(20)

    def seeded(C, G):
        H = C // G

        def u(*s):
            return 0.25 * (2 * torch.rand(s, generator=g, device="cuda") - 1)

        return [1 + 0.1 * u(C), 0.1 * u(C), u(1, G, H, 3 * H),
                u(1, G, H, 3 * H), u(1, G, 3 * H), u(1, G, 3 * H)]

    cases = [("L516", 1023, 516, 64, 4, demo),
             ("L644", 825, 644, 64, 4, demo),
             ("S3588", 132, 3588, 64, 4, demo),
             ("dense64_g1", 33, 516, 64, 1, seeded(64, 1)),
             ("dense64_g2", 33, 516, 64, 2, seeded(64, 2)),
             ("C32_g4", 825, 644, 32, 4, seeded(32, 4)),
             ("C128_g4", 825, 644, 128, 4, seeded(128, 4))]
    out = {"tree": args.label, "device": gpu_name_and_power_limit(),
           "build_s": build_s, "cases": []}
    for name, N, L, C, G, params in cases:
        x = torch.randn((N, L, C), generator=g, device="cuda")

        def call():
            return fused_grouped_gru(x, *params, bidirectional=False)

        got = call()
        torch.cuda.synchronize()
        err = (got - grouped_gru_plain(x, *params, False)).abs().max().item()
        del got
        torch.cuda.empty_cache()
        ms = [cs.cuda_ms(torch, call, 5) for _ in range(args.runs)]
        lib_ms, _ = cs.library_gru(torch, layer_norm(x, *params[:2]),
                                   *params[2:])
        out["cases"].append({"case": name, "N": N, "L": L, "C": C,
                             "groups": G, "max_abs_err": err, "ms": ms,
                             "library_ms": lib_ms})
        del x
        torch.cuda.empty_cache()
    if args.ftf:
        from lct_gan_tpu_torch.ops.ftf import fused_ftf_block

        out["ftf"] = []
        for name, block, N, L, masked, lookback in (
                ("freq", gen.GRUf1, 16512, 33, False, None),
                ("time_keybias", gen.GRUt1, 4224, 129, True, None),
                ("time_lookback16", gen.GRUt1, 4224, 129, False, 16)):
            params = [p.detach().contiguous() for p in block.kernel_params()]
            x = torch.randn((N, L, 64), generator=g, device="cuda")
            kb = None
            if masked:
                valid = torch.randint(L - 40, L + 1, (N,), generator=g,
                                      device="cuda")
                pos = torch.arange(L, device="cuda")
                kb = torch.where(pos[None, :] < valid[:, None], 0.0,
                                 -1e30).to(torch.float32)
            for mode in ("bf16", "precise"):
                kw = dict(bidirectional=block.bidirectional, num_heads=4,
                          lookback=lookback, key_bias=kb,
                          precise=mode == "precise")
                out["ftf"].append({"case": name, "mode": mode, "ms": [
                    cs.cuda_ms(torch, lambda: fused_ftf_block(
                        x, *params, **kw), 5) for _ in range(args.runs)]})
            del x, kb
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

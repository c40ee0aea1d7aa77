"""Time one checkout's single-device (world-1) path on the card, to hold a
change against its parent in one call:

    python3 lct_gan_tpu_torch/time_checkout.py TREE LABEL
        [--parts fixed,b64,loop,bwd64] [--timed 5] [--import_dist]

TREE is the root of a checkout (e.g. a `git archive` of the parent); its
own `lct_gan_tpu_torch` and `chip_smoke.py` are imported, so run this file
by path, not with -m. Prints one JSON line: the fixed call (make_enhance,
B = 128 x 2 s, five medians of 5 calls), the B = 64 x 2 s train step
(median of --timed steps after 2 warm-up, split into its phases),
run_training for 2 epochs on chip_smoke.py's synthetic corpus (epoch 2's
median in-loop step and audio-sec/s), and with part bwd64 (not in the
default) the bf16 FTF backward at C = 64, 4 heads and 4 groups, at the
B = 64 x 2 s training shapes (frequency block N = 8,256 x 33, time block
N = 2,112 x 129; five means of 5 launches each). --import_dist imports
torch.distributed first. Run the two trees in turns (parent, change,
change, parent, ...), one process each, and compare within one call.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree")
    parser.add_argument("label")
    parser.add_argument("--parts", default="fixed,b64,loop")
    parser.add_argument("--timed", type=int, default=5)
    parser.add_argument("--import_dist", action="store_true")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))
    if args.import_dist:
        import torch.distributed  # noqa: F401
    tree = os.path.abspath(args.tree)
    # Run by path, this file's directory is sys.path[0]: the tree replaces
    # it, so the tree's package and chip_smoke.py are the ones imported.
    sys.path[0] = tree
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from lct_gan_tpu_torch.convert import load_enhancer, read_npz_params
    from lct_gan_tpu_torch.eval import make_enhance
    from lct_gan_tpu_torch.ops._build import build_all
    from lct_gan_tpu_torch.train import (DataConfig, TrainConfig,
                                         create_state, run_training)
    from lct_gan_tpu_torch.utils import disable_tf32

    disable_tf32()
    build_all()
    out = {"tree": args.label, "import_dist": args.import_dist}
    if "fixed" in parts:
        enhance = make_enhance(load_enhancer(cs.CHECKPOINT, device="cuda"))
        x = torch.from_numpy((0.1 * np.random.default_rng(1).standard_normal(
            (128, 32000))).astype(np.float32)).cuda()
        runs = [cs.cuda_ms(torch, lambda: enhance(x), 5) for _ in range(5)]
        out.update(fixed_ms_runs=runs, fixed_ms_median=statistics.median(runs))
        del enhance, x
        torch.cuda.empty_cache()
    if "b64" in parts:
        cfg = TrainConfig()
        state = create_state(cfg, torch.Generator().manual_seed(0),
                             device="cuda",
                             g_params=read_npz_params(cs.CHECKPOINT)[0])
        out["train_b64"] = cs.timed_steps(torch, cfg, state, np,
                                          np.random.default_rng(7), 64,
                                          n_timed=args.timed)
        del state
        torch.cuda.empty_cache()
    if "bwd64" in parts:
        from lct_gan_tpu_torch.ops.ftf import ftf_forward_with_hidden
        from lct_gan_tpu_torch.ops.ftf_bwd import fused_ftf_bwd

        g = torch.Generator(device="cuda").manual_seed(5)
        blocks = cs.seeded_blocks(torch, 0, 64, 4, 4)
        for name, blk, N, L in (("freq", blocks[0], 64 * 129, 33),
                                ("time", blocks[1], 64 * 33, 129)):
            params = [p.detach().contiguous() for p in blk.kernel_params()]
            kw = dict(bidirectional=blk.bidirectional, num_heads=4,
                      lookback=None, precise=False)
            x = torch.randn((N, L, 64), generator=g, device="cuda")
            hid = ftf_forward_with_hidden(x, *params, **kw)[1]
            dout = torch.randn((N, L, 64), generator=g, device="cuda")
            runs = [cs.cuda_ms(torch, lambda: fused_ftf_bwd(
                x, *params, hid, dout, **kw), 5) for _ in range(5)]
            out[f"bwd64_{name}_ms_runs"] = runs
            out[f"bwd64_{name}_ms_median"] = statistics.median(runs)
            del x, hid, dout
            torch.cuda.empty_cache()
    if "loop" in parts:
        root = tempfile.mkdtemp(prefix="lct_time_")
        try:
            cs.write_corpus(np, os.path.join(root, "data"))
            run = run_training(
                TrainConfig(epochs=2, val_interval=1, ckpt_interval=1),
                DataConfig(data_root=os.path.join(root, "data")),
                expr_root=os.path.join(root, "e"), device="cuda",
                compute_pesq=False, compute_stoi=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        e2 = run["epochs"][1]
        out.update(loop_epoch2_step_ms_median=statistics.median(
            e2["step_ms"]), loop_epoch2_audio_sec_per_s=e2["audio_sec_per_s"],
            loop_epoch_seconds=[e["seconds"] for e in run["epochs"]])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

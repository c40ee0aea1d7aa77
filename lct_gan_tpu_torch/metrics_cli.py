"""Evaluate a directory of enhanced wavs against the clean test set (the JAX
package's `metrics.py` contract, on the port's `metrics`).

    python -m lct_gan_tpu_torch.metrics_cli --data_root D --enhanced_dir O \
        [--test_scp test.scp] [--clean_dir C] [--no_pesq] [--no_stoi] \
        [--estoi] [--no_si_sdr]

Computes SI-SDR, PESQ, STOI and fwSegSNR between O/<id>.wav and
<clean_dir>/<id>.wav for every id of the scp, and prints the mean +/- std
of each metric. clean_dir defaults to
D/clean_test, the trainer's layout. Runs on the host: no card needed.
"""

from __future__ import annotations

import argparse
import math
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate enhanced wavs against clean references")
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--test_scp", type=str, default="test.scp")
    parser.add_argument("--enhanced_dir", type=str, required=True)
    parser.add_argument("--clean_dir", type=str, default=None,
                        help="Defaults to <data_root>/clean_test")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--no_pesq", action="store_true")
    parser.add_argument("--no_stoi", action="store_true")
    parser.add_argument("--estoi", action="store_true",
                        help="Extended STOI instead of classic STOI")
    parser.add_argument("--no_si_sdr", action="store_true",
                        help="Skip SI-SDR")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from lct_gan_tpu_torch.data import read_scp
    from lct_gan_tpu_torch.metrics import (compute_metrics_for_pair,
                                           pesq_available)

    if not args.no_pesq and not pesq_available():
        print("NOTICE: `pesq` wheel unavailable -- PESQ slots will be NaN. "
              "Acceptance falls back to SI-SDR/STOI/fwSegSNR "
              "(see BASELINE.md, PESQ-unavailable acceptance procedure).")

    scp = args.test_scp
    if not os.path.isabs(scp):
        scp = os.path.join(args.data_root, scp)
    ids = read_scp(scp)
    clean_dir = args.clean_dir or os.path.join(args.data_root, "clean_test")

    per_metric = {}
    n_missing = 0
    for uid in ids:
        clean_path = os.path.join(clean_dir, f"{uid}.wav")
        enh_path = os.path.join(args.enhanced_dir, f"{uid}.wav")
        if not (os.path.exists(clean_path) and os.path.exists(enh_path)):
            print(f"WARNING: missing files for {uid}, skipping")
            n_missing += 1
            continue
        m = compute_metrics_for_pair(
            clean_path, enh_path, args.sample_rate,
            include_pesq=not args.no_pesq,
            include_stoi=not args.no_stoi,
            include_si_sdr=not args.no_si_sdr,
            estoi=args.estoi)
        for k, v in m.items():
            if math.isfinite(v):
                per_metric.setdefault(k, []).append(v)

    print(f"Evaluated {len(ids) - n_missing}/{len(ids)} utterances")
    for k in sorted(per_metric):
        vals = np.asarray(per_metric[k])
        print(f"{k}: {vals.mean():.4f} +/- {vals.std():.4f} "
              f"(n={len(vals)})")


if __name__ == "__main__":
    main()

"""Registers, spills and static shared memory of every kernel instance of a
width's libraries (16 .. 512), as ptxas reports them, for one checkout or
two side by side:

    python3 -m lct_gan_tpu_torch.ptxas_report [--width 64] [--json OUT]
        [TREE ...]

Each TREE is the root of a checkout (default: this one); the
`lct_gan_tpu_torch/csrc/*.cu` of the width's libraries (the FTF
backward's too, at the widths it is built for) are compiled with the
build's flags
(`ops/_build.py`) and -Xptxas -v into a temporary directory, every source
of every tree in one parallel batch of nvcc processes. Prints one JSON line
per tree ({kernel: {registers, spill_stores, spill_loads, smem}}, each kernel
named by its instance: demangled where cu++filt is found, without the
return type and the parameter list) and, for two trees, a line of the
kernels whose counts differ (the second against the first). Needs nvcc,
not a card. --json writes {tree: usage} to OUT as well.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from lct_gan_tpu_torch.ops import _build


def _demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.isfile(tool):
        return {n: n for n in names}
    out = subprocess.run([tool, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def instance_names(names):
    """{mangled: the instance's name} for kernel names from ptxas: demangled
    where cu++filt is found, without the return type and the parameter
    list (which a change of arguments alone changes)."""
    plain = _demangle(sorted(names))
    return {n: re.sub(r"\((?:[^()]|\([^()]*\))*\)$", "",
                      plain[n]).replace("void ", "", 1) for n in names}


def tree_usage(trees, width):
    """{tree: {kernel: counts}} for the sources of `width`'s libraries
    (ops/_build.py::library_sources, the FTF backward's too where it is
    built) in each tree."""
    from lct_gan_tpu_torch.ops.library import BACKWARD_WIDTHS

    nvcc = _build._nvcc()
    define = [] if width == _build.DEFAULT_C else [f"-DLCT_C={width}"]
    names = _build.library_sources(width, backward=width in BACKWARD_WIDTHS)
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            csrc = os.path.join(tree, "lct_gan_tpu_torch", "csrc")
            for src in (n + ".cu" for n in names):
                if not os.path.isfile(os.path.join(csrc, src)):
                    continue
                cmd = [nvcc, *_build.NVCC_FLAGS, *define, "-I", csrc,
                       "-Xptxas", "-v", "-o",
                       os.path.join(tmp, f"{i}-{src}.so"),
                       os.path.join(csrc, src)]
                procs.append((tree, src, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
        usage = {tree: {} for tree in trees}
        for tree, src, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {tree} {src}:\n{err}")
            usage[tree].update(_build.ptxas_usage(err + out))
    plain = instance_names({k for u in usage.values() for k in u})
    return {tree: dict(sorted((plain[k], v) for k, v in u.items()))
            for tree, u in usage.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--width", type=int, default=_build.DEFAULT_C)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [os.path.abspath(t) for t in args.trees] or [root]
    usage = tree_usage(trees, args.width)
    for tree in trees:
        print(json.dumps({"tree": tree, "width": args.width,
                          "kernels": usage[tree]}), flush=True)
    if len(trees) == 2:
        a, b = (usage[t] for t in trees)
        changed = {k: {"first": a.get(k), "second": b.get(k)}
                   for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)}
        print(json.dumps({"width": args.width, "instances": len(b),
                          "changed": changed}), flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(usage, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

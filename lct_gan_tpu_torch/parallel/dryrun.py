"""GAN train steps over n data-parallel ranks against the 1-rank step (the
port's counterpart of `__graft_entry__.py::dryrun_multichip`).

    python -m lct_gan_tpu_torch.parallel.dryrun [n] [--device cpu]

`dryrun` spawns n ranks (parallel.spawn), each of which builds the train
state from the same seed, broadcasts rank 0's, and runs the step on its rows
of seeded global batches; the calling process runs the 1-rank step on the
whole batches from the same state on the same device. It checks, and
raises otherwise:
  * after every step, every rank's parameters, buffers and AdamW states
    are bit-equal to rank 0's;
  * step 1's metrics and parameters match the 1-rank step's, with the JAX
    package's DP tolerances (tests/test_train_step.py): metrics rtol 2e-4
    atol 1e-6; parameters rtol 1e-3 and atol 2e-6 on the CPU's plain path,
    1e-5 through the card's kernels (the all-reduce reassociates their
    gradient sums, and AdamW's first step is about lr * sign(g)).
The tests and chip_smoke.py run it at tiny shapes; `rank_steps` is also
what chip_smoke.py runs per rank at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from lct_gan_tpu_torch.parallel.mesh import (Mesh, broadcast_state_,
                                             replicas_equal, shard_batch,
                                             spawn)

__all__ = ["StateInit", "TOL", "make_state", "named_params", "rank_steps",
           "one_rank_steps", "compare_step1", "seeded_batches", "dryrun"]

TOL = {"cpu": {"metric_rtol": 2e-4, "metric_atol": 1e-6,
               "param_rtol": 1e-3, "param_atol": 2e-6},
       "cuda": {"metric_rtol": 2e-4, "metric_atol": 1e-6,
                "param_rtol": 1e-3, "param_atol": 1e-5}}
KERNELS = ("fused_ftf_block", "fused_ftf_bwd", "fused_mhsa", "banded_mhsa")


@dataclasses.dataclass(frozen=True)
class StateInit:
    """Where a train state comes from, the same on every rank: a seeded
    `create_state` (optionally with the JAX package's generator weights
    from an .npz), or JAX-package param trees (g, mpd, msd) through the
    weight bridge. precise: all-f32 FTF kernels."""

    seed: int = 0
    g_npz: Optional[str] = None
    jax_params: Optional[Tuple[Any, Any, Any]] = None
    precise: bool = False


def make_state(cfg, init: StateInit, device):
    from lct_gan_tpu_torch.train import create_state, state_from_jax_params

    if init.jax_params is not None:
        return state_from_jax_params(cfg, *init.jax_params, device=device,
                                     precise=init.precise)
    g_params = None
    if init.g_npz is not None:
        from lct_gan_tpu_torch.convert import read_npz_params

        g_params, _ = read_npz_params(init.g_npz)
    return create_state(cfg, torch.Generator().manual_seed(init.seed),
                        device=device, precise=init.precise,
                        g_params=g_params)


def named_params(state) -> Dict[str, torch.Tensor]:
    """Every parameter of the state, as "enhancer.<name>", "mpd.<name>" and
    "msd.<name>"."""
    return {f"{part}.{n}": p for part in ("enhancer", "mpd", "msd")
            for n, p in getattr(state, part).named_parameters()}


def _capture_grads(state, out: Dict[str, Dict[str, np.ndarray]]):
    """Record the gradients each optimizer consumes at its next step (the
    D ones after the all-reduce, the G ones after the all-reduce and the
    clip) by `named_params` name, in out["d"] and out["g"]."""
    names = {id(p): n for n, p in named_params(state).items()}
    for key, opt in (("d", state.d_opt), ("g", state.g_opt)):
        inner = opt.step

        def step(*a, _key=key, _opt=opt, _inner=inner, **k):
            out[_key] = {names[id(p)]: p.grad.detach().cpu().numpy().copy()
                         for g in _opt.param_groups for p in g["params"]}
            del _opt.step  # back to the class's step
            return _inner(*a, **k)

        opt.step = step


def _counters():
    from lct_gan_tpu_torch import ops

    return [getattr(ops, name) for name in KERNELS]


def _timed_step(step, state, noisy, clean, device):
    """One step; its metrics, device ms (CUDA events; host ms on the CPU)
    from start to end and inside the all-reduces, and host ms."""
    cuda = device.type == "cuda"
    marks = []

    def mark(phase):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((phase, ev))
        else:
            marks.append((phase, time.perf_counter()))

    t0 = time.perf_counter()
    mark("start")
    metrics = step(state, noisy, clean, mark)
    if cuda:
        torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3

    def ms(a, b):
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    at = dict(marks)
    phases = {f"{b[0]}_ms": ms(a[1], b[1]) for a, b in zip(marks, marks[1:])}
    reduce_ms = sum(phases.get(k, 0.0) for k in ("d_reduce_ms",
                                                 "g_reduce_ms"))
    return metrics, {"step_ms": ms(at["start"], at["g_step"]),
                     "reduce_ms": reduce_ms, "wall_ms": wall, **phases}


def rank_steps(mesh: Mesh, cfg, init: StateInit, noisy: np.ndarray,
               clean: np.ndarray, capture: bool = False) -> Dict[str, Any]:
    """Run by every rank: the state from `init`, rank 0's broadcast; one
    step per global batch noisy[s], clean[s] ([steps, B, T]) on this rank's
    rows. Returns per step the metrics, whether the replicas are bit-equal,
    the kernels' launches and the timings; rank 0 also step 1's parameters
    and, with `capture`, the gradients its optimizers consumed."""
    from lct_gan_tpu_torch.train import make_train_step

    state = broadcast_state_(make_state(cfg, init, mesh.device), mesh)
    step = make_train_step(cfg, mesh)
    out: Dict[str, Any] = {"rank": mesh.rank, "device": str(mesh.device),
                           "backend": mesh.backend, "metrics": [],
                           "replicas_equal": [], "launches": [],
                           "timing": []}
    grads: Dict[str, Dict[str, np.ndarray]] = {}
    for s in range(noisy.shape[0]):
        rows = shard_batch({"noisy": noisy[s], "clean": clean[s]}, mesh)
        if capture and s == 0:
            _capture_grads(state, grads)
        counters = _counters()
        for c in counters:
            c.launches = 0
        metrics, timing = _timed_step(
            step, state, torch.from_numpy(rows["noisy"]).to(mesh.device),
            torch.from_numpy(rows["clean"]).to(mesh.device), mesh.device)
        out["launches"].append({name: c.launches
                                for name, c in zip(KERNELS, counters)})
        out["timing"].append(timing)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["replicas_equal"].append(replicas_equal(state, mesh))
        if s == 0 and mesh.is_main:
            # A copy: on the CPU, .cpu().numpy() would share the
            # parameter's memory, which the next steps update.
            out["params_step1"] = {
                k: v.detach().to("cpu", copy=True).numpy()
                for k, v in named_params(state).items()}
    if capture and mesh.is_main:
        out["grads_step1"] = grads
    return out


def one_rank_steps(cfg, init: StateInit, noisy: np.ndarray,
                   clean: np.ndarray, device, capture: bool = False
                   ) -> Dict[str, Any]:
    """The 1-rank run of `rank_steps` in this process on `device`."""
    from lct_gan_tpu_torch.parallel.mesh import make_mesh

    return rank_steps(make_mesh(1, device), cfg, init, noisy, clean,
                      capture)


def compare_step1(ref: Dict[str, Any], ranks: List[Dict[str, Any]],
                  tol: Dict[str, float]) -> Dict[str, Any]:
    """Hold the ranks' runs against the 1-rank run: replicas bit-equal
    after every step, the ranks' metrics equal, step 1's metrics and rank
    0's parameters within `tol`. Returns the largest differences and the
    five tensors nearest their bound; raises AssertionError on a
    failure."""
    for r in ranks:
        if not all(r["replicas_equal"]):
            raise AssertionError(f"rank {r['rank']}'s replicas differ from "
                                 f"rank 0's: {r['replicas_equal']}")
        if r["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"rank {r['rank']}'s metrics differ")
    want, got = ref["metrics"][0], ranks[0]["metrics"][0]
    metric_err = {}
    for k in want:
        err = abs(got[k] - want[k])
        metric_err[k] = err
        if not err <= tol["metric_atol"] + tol["metric_rtol"] * abs(want[k]):
            raise AssertionError(f"step 1 metric {k}: {got[k]} vs 1-rank "
                                 f"{want[k]}")
    per_tensor = []
    for k, a in ref["params_step1"].items():
        diff = np.abs(ranks[0]["params_step1"][k] - a)
        excess = diff - (tol["param_atol"] + tol["param_rtol"] * np.abs(a))
        per_tensor.append((float(excess.max()), k, float(diff.max()),
                           int((excess > 0).sum()), a.size))
    per_tensor.sort(reverse=True)
    worst = [{"param": k, "max_abs_diff": d, "over_tol": n, "size": size}
             for _, k, d, n, size in per_tensor[:5]]
    if per_tensor[0][0] > 0:
        raise AssertionError(f"step 1 parameters over the tolerance {tol}: "
                             f"{[w for w in worst if w['over_tol']]}")
    return {"metric_abs_err": metric_err,
            "param_max_abs_err": max(d for _, _, d, _, _ in per_tensor),
            "param_worst": worst, "tol": tol}


def seeded_batches(steps: int, batch: int, samples: int, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """[steps, batch, samples] noisy / clean, the JAX package's test recipe
    (clean 0.1 * N(0, 1), noisy clean + 0.05 * N(0, 1))."""
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((steps, batch, samples))).astype(
        np.float32)
    noisy = clean + (0.05 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    return noisy, clean


def dryrun(n: int = 2, device="cuda", *, cfg=None,
           init: StateInit = StateInit(precise=True), steps: int = 1,
           rows_per_rank: int = 2, seed: int = 1, capture: bool = False,
           backend: Optional[str] = None) -> Dict[str, Any]:
    """`steps` GAN steps over n ranks against the 1-rank steps, at tiny
    shapes by default (TrainConfig(segment_seconds=0.25), rows_per_rank
    rows a rank), with all-f32 FTF kernels by default, as the JAX dry run's
    kernel leg. (On the CPU's bf16 plain path the attention key bias, whose
    gradient is 0 but for rounding, gets noise above AdamW's eps that
    differs between batch splits, and AdamW's first step turns it into
    ~lr-sized updates either way; the card's bf16 kernels hold it to
    1.4e-8 at full width.) Returns {"compare", "ranks", "reference", "noisy",
    "clean"}; raises when a check fails."""
    from lct_gan_tpu_torch.train import TrainConfig
    from lct_gan_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = TrainConfig(segment_seconds=0.25, batch_size=n * rows_per_rank)
    noisy, clean = seeded_batches(steps, cfg.batch_size, cfg.segment_length,
                                  seed)
    ranks = spawn(rank_steps, n, device, backend, cfg, init, noisy, clean,
                  capture)
    ref = one_rank_steps(cfg, init, noisy, clean, dev, capture)
    report = compare_step1(ref, ranks, TOL[dev.type])
    return {"compare": report, "ranks": ranks, "reference": ref,
            "noisy": noisy, "clean": clean}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out = dryrun(args.n, args.device)
    ranks = out["ranks"]
    print(json.dumps({"dryrun": f"{args.n} ranks", "device": args.device,
                      "backend": ranks[0]["backend"],
                      "rank_devices": [r["device"] for r in ranks],
                      "metrics_step1": ranks[0]["metrics"][0],
                      "launches_per_rank": [r["launches"] for r in ranks],
                      **out["compare"]}))
    print(f"dryrun({args.n}): OK")


if __name__ == "__main__":
    main()

"""Data parallelism over torch.distributed (the counterpart of
`lct_gan_tpu/parallel/mesh.py`).

The JAX package replicates the parameters over a device mesh and shards
every batch's leading axis over its 'data' axis; XLA inserts the gradient
all-reduce. Here each rank is a process with its own replica of the train
state on its own device, it runs the step on its rows of the global batch,
and the step all-reduces the gradients itself (`all_reduce_mean_`), before
the optimizers step and before G's global-norm clip, where XLA puts them.

Backend rule (`make_mesh`):
  * nccl when each rank has a card of its own (rank r on cuda:r);
  * gloo when ranks share a card (more ranks than cards, or a device with
    an index, which pins every rank to that card) and on the CPU. gloo
    reduces CUDA tensors through host memory.
NCCL cannot put two ranks on one card, and nothing falls back from one
backend to the other.

World 1 makes no process group, and every function here is then the
identity.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import queue
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from lct_gan_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "default_world", "make_mesh", "shard_batch",
           "all_reduce_mean_", "all_reduce_sum_", "broadcast_state_",
           "replicas_equal", "state_tensors", "broadcast_object", "barrier",
           "spawn", "close_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str]   # None at world 1 (no process group)
    group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _backend_and_device(world: int, device: torch.device, local_rank: int):
    if device.type == "cpu":
        return "gloo", device
    if device.index is not None:
        return "gloo", device
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def default_world(device="cuda") -> int:
    """The JAX package's default data-parallel size (all devices): every
    visible card on "cuda", 1 on "cpu"."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_mesh(data_parallel: Optional[int] = None, device="cuda", *,
              rank: Optional[int] = None, init_method: Optional[str] = None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's `Mesh` (replaces `lct_gan_tpu.parallel.make_mesh`).

    data_parallel: the number of ranks; by default every visible card on
      "cuda" and 1 on "cpu" (the JAX package's default: all devices).
    device: "cuda" places rank r on cuda:r when there are enough cards
      (nccl) and shares the cards otherwise (gloo); "cuda:<i>" pins every
      rank to card i (gloo); "cpu" runs every rank on the CPU (gloo).
    rank, init_method: this process's rank and the group's rendezvous; by
      default RANK and env:// (a torchrun launch). `spawn` passes a file://
      path in a temporary directory.
    backend: when given, must be the one the rule picks (a caller states
      what it expects; nothing is switched).

    Sets the rank's device before the group starts, and prints the choice
    on rank 0.
    """
    dev = resolve_device(device)
    world = int(default_world(dev) if data_parallel is None
                else data_parallel)
    if world < 1:
        raise ValueError(f"data_parallel must be >= 1, got {world}")
    if world == 1:
        return Mesh(0, 1, dev, None)
    if rank is None:
        rank = int(os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    chosen, dev = _backend_and_device(world, dev, local_rank)
    if backend is not None and backend != chosen:
        raise ValueError(
            f"backend {backend!r} asked for, but {world} ranks on "
            f"{device!r} with {torch.cuda.device_count()} card(s) take "
            f"{chosen!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(chosen, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    devices: List[Any] = [None] * world
    dist.all_gather_object(devices, str(dev))
    if rank == 0:
        print(f"Data parallel: {world} ranks, backend {chosen}, devices "
              f"{devices}", flush=True)
    return Mesh(rank, world, dev, chosen, dist.group.WORLD)


def close_mesh(mesh: Mesh) -> None:
    """Destroy the mesh's process group (none at world 1)."""
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                keys: Sequence[str] = ("noisy", "clean", "lengths")
                ) -> Dict[str, Any]:
    """This rank's rows [r*B/W, (r+1)*B/W) of a global batch's arrays
    (replaces `lct_gan_tpu.parallel.shard_batch`, which device_puts them
    sharded over the 'data' axis). B must divide by W."""
    if mesh.world == 1:
        return batch
    out = dict(batch)
    for k in keys:
        if k not in out:
            continue
        b = out[k].shape[0]
        if b % mesh.world:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"{mesh.world} ranks")
        n = b // mesh.world
        out[k] = out[k][mesh.rank * n:(mesh.rank + 1) * n]
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     op: Callable[[torch.Tensor], None]) -> None:
    """Run `op` on one flat buffer per dtype on the mesh's device, holding
    `tensors`, and copy the result back into them."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device)
                          for t in group])
        op(flat)
        offset = 0
        for t in group:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> Sequence[torch.Tensor]:
    """Sum `tensors` over the ranks, in place: one all-reduce per dtype."""
    if mesh.world > 1 and tensors:
        _flat_collective(tensors, mesh, lambda flat: dist.all_reduce(
            flat, op=dist.ReduceOp.SUM, group=mesh.group))
    return tensors


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh
                     ) -> Sequence[torch.Tensor]:
    """Average `tensors` over the ranks, in place: the gradients flattened
    into one buffer, one all-reduce (SUM), divided by W, unflattened. This
    is the all-reduce XLA inserts for gradients of replicated parameters
    taken against a sharded batch."""
    if mesh.world > 1 and tensors:
        def op(flat):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat.div_(mesh.world)
        _flat_collective(tensors, mesh, op)
    return tensors


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a GanTrainState, in an order all ranks share: the
    three models' parameters and buffers (spectral-norm u / v included),
    then both AdamW states."""
    out: List[torch.Tensor] = []
    for module in (state.enhancer, state.mpd, state.msd):
        out += [p.data for p in module.parameters()]
        out += list(module.buffers())
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                out += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
    return out


def _same_layout(tensors: Sequence[torch.Tensor], mesh: Mesh) -> bool:
    """Whether every rank holds as many tensors and elements (checked
    before a collective over them, which would hang on a mismatch)."""
    n = torch.tensor([len(tensors), sum(t.numel() for t in tensors)],
                     dtype=torch.int64, device=mesh.device)
    both = torch.cat([n, -n])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(torch.equal(both[:2], -both[2:]))


def replicas_equal(state, mesh: Mesh) -> bool:
    """Whether every rank's state is bit-equal to rank 0's (the same answer
    on every rank): the bytes of every state tensor in one buffer, rank 0's
    broadcast and compared on each rank."""
    if mesh.world == 1:
        return True
    tensors = state_tensors(state)
    same = _same_layout(tensors, mesh)
    if same:
        local = torch.cat([t.detach().contiguous().reshape(-1)
                           .view(torch.uint8).to(mesh.device)
                           for t in tensors])
        ref = local.clone()
        dist.broadcast(ref, src=0, group=mesh.group)
        same = torch.equal(ref, local)
        del local, ref
    flag = torch.tensor([int(same)], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def broadcast_state_(state, mesh: Mesh):
    """Make every rank's state rank 0's: broadcast every parameter, buffer
    and optimizer tensor from rank 0, then check that the replicas are
    bit-equal (the counterpart of placing the JAX state with
    `replicated_sharding`). Raises when the ranks' states differ in
    layout, or differ after the broadcast."""
    if mesh.world == 1:
        return state
    tensors = state_tensors(state)
    if not _same_layout(tensors, mesh):
        raise RuntimeError("the ranks' train states differ in layout "
                           "(tensor or element counts)")
    _flat_collective(tensors, mesh, lambda flat: dist.broadcast(
        flat, src=0, group=mesh.group))
    if not replicas_equal(state, mesh):
        raise RuntimeError("replicas differ after the broadcast from rank 0")
    return state


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's `obj` (picklable) on every rank."""
    if mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (a no-op at world 1)."""
    if mesh.world > 1:
        dist.barrier(group=mesh.group)


def _rank_main(rank, world, device, backend, init_method, fn, args, results):
    if sys.platform.startswith("linux"):
        # PR_SET_PDEATHSIG: end this rank with its parent, even when the
        # parent is killed and cannot terminate it.
        ctypes.CDLL(None).prctl(1, int(signal.SIGTERM))
    try:
        if os.environ.get("OMP_NUM_THREADS") is None:
            # torchrun's default for more than one process a host: one
            # thread a rank, so the ranks do not fight over the cores.
            torch.set_num_threads(1)
        mesh = make_mesh(world, device, rank=rank, init_method=init_method,
                         backend=backend)
        try:
            out = fn(mesh, *args)
        finally:
            close_mesh(mesh)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, device="cuda",
          backend: Optional[str] = None, *args, timeout: float = 3600.0
          ) -> List[Any]:
    """Run `fn(mesh, *args)` in `world` new processes (the spawn start
    method: the caller may hold a CUDA context, which fork would break),
    one rank each, over a file:// rendezvous in a temporary directory.
    Returns the ranks' results in rank order (each must pickle: CPU objects
    only). Raises, with the failing rank's traceback, if any rank fails."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lct_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device, backend, init_method, fn,
                               args, results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # A failing rank reports before it exits; one killed,
                    # or crashed in native code, does not.
                    try:
                        rank, ok, out = results.get(timeout=10.0)
                    except queue.Empty:
                        raise RuntimeError(
                            "rank processes exited with codes "
                            f"{[p.exitcode for p in procs]}, no result"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

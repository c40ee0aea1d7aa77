"""Serialized-model export (`lct_gan_tpu/export_model.py`).

The reference ships its model as a TorchScript program with the weights
baked in (`FTFNet_scripted.pt`); the JAX package as StableHLO per bucket
shape. The port's artifact is one `torch.export` program per (batch,
samples) shape, the weights held as its constants:

  * portable (the default, as in the JAX package): the program is traced,
    then each kernel op (`torch.ops.lct_gan_tpu_torch.*`) is decomposed
    into its plain version, so it holds ATen ops only. It loads with
    `torch` alone and runs on the CPU or on the card (`load_exported`
    moves its constants to the device asked for). This is the
    counterpart of the JAX package's `pallas_override(None)`: nothing
    global forces the plain route, the decomposition replaces the nodes.
    A caller with `torch` alone sets `torch.backends.cudnn.allow_tf32 =
    False`, as `load_exported` does: else the card runs the program's f32
    convs in TF32.
  * keep_kernels: the program keeps the kernel ops. Loading it needs
    `import lct_gan_tpu_torch` (which registers them); on the card each op
    launches its CUDA kernel and counts its launch, as in eager serving.

Routing (`L <= MAX_FTF_SEQ`, `BANDED_KERNEL_MIN_SEQ`) is decided when a
program is traced, which one program per shape makes right. The signature
is `noisy [B, T]` only, as in the JAX package: no `lengths`.

Artifact layout: one .zip holding `meta.json` (format, sample_rate,
compress_c, max_time_context, kernels, precise, shapes) and one
`b<B>_t<T>.pt2` per shape, written by `torch.export.save`.
"""

from __future__ import annotations

import collections
import copy
import io
import json
import time
import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from lct_gan_tpu_torch.data.pipeline import bucket_length
from lct_gan_tpu_torch.ops.attention import mhsa_plain
from lct_gan_tpu_torch.ops.banded_attention import banded_plain
from lct_gan_tpu_torch.ops.ftf import ftf_plain
from lct_gan_tpu_torch.ops.gru import grouped_gru_plain
from lct_gan_tpu_torch.ops.library import NAMESPACE
from lct_gan_tpu_torch.utils.device import disable_tf32, resolve_device

__all__ = ["export_enhancer", "load_exported", "ExportedEnhancer",
           "adaptive_export_shapes", "kernel_op_counts"]


def adaptive_export_shapes(min_seconds: float, max_seconds: float,
                           sample_rate: int = 16000,
                           target_batch_seconds: float = 256.0,
                           max_batch: int = 128
                           ) -> List[Tuple[int, int]]:
    """(batch, samples) export table mirroring the infer CLI's
    length-adaptive bucketed batching: one shape per geometric length
    bucket covering [min_seconds, max_seconds], with rows = clamp(target //
    bucket, 1, max_batch) -- short buckets serve at large B, long buckets
    at small B, padded batch about constant (`lct_gan_tpu/export_model.py:
    33`). ExportedEnhancer's smallest-covering-shape selection then picks
    the bucket per request."""
    target = int(target_batch_seconds * sample_rate)
    stop = int(max_seconds * sample_rate)
    shapes: List[Tuple[int, int]] = []
    t = bucket_length(int(min_seconds * sample_rate))
    while True:
        shapes.append((max(1, min(int(max_batch), target // t)), t))
        if t >= stop:
            return shapes
        t = bucket_length(t + 1)


def _plain_decompositions():
    """Each kernel op on the serving path -> its plain version."""
    ns = getattr(torch.ops, NAMESPACE)
    return {ns.fused_ftf_block.default: ftf_plain,
            ns.fused_mhsa.default: mhsa_plain,
            ns.banded_mhsa.default: banded_plain,
            ns.fused_grouped_gru.default: grouped_gru_plain}


def kernel_op_counts(program) -> Dict[str, int]:
    """Nodes of each kernel op in an ExportedProgram or its module's graph,
    by op name."""
    return dict(collections.Counter(
        node.target.name().split("::")[1].split(".")[0]
        for node in program.graph.nodes
        if getattr(node.target, "namespace", None) == NAMESPACE))


def export_enhancer(path: str, enhancer, shapes: Sequence[Tuple[int, int]],
                    keep_kernels: bool = False,
                    sample_rate: int = 16000) -> Dict[Tuple[int, int], float]:
    """Serialize `enhancer` (an LctEnhancer) at each (batch, samples) shape
    into the zip `path`; returns the export seconds per shape.

    Each program is traced with zero inputs of the shape (no kernel runs:
    tracing goes through the ops' fake implementations). Portable
    (default): traced on a CPU copy of the enhancer, so its constants load
    on any machine, then every kernel op is decomposed into its plain
    version. keep_kernels=True: traced on the enhancer's device, the kernel
    ops kept."""
    enhancer.eval()
    if not keep_kernels:
        enhancer = copy.deepcopy(enhancer).cpu()
    dev = next(enhancer.parameters()).device
    meta = {
        "format": 1,
        "sample_rate": int(sample_rate),
        "compress_c": float(enhancer.c),
        "max_time_context": enhancer.gen.cfg.max_time_context,
        "kernels": bool(keep_kernels),
        "precise": bool(enhancer.gen.GRUf1.precise),
        "shapes": [[int(b), int(t)] for b, t in shapes],
    }
    seconds = {}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for b, t in meta["shapes"]:
            t0 = time.perf_counter()
            x = torch.zeros((b, t), dtype=torch.float32, device=dev)
            program = torch.export.export(enhancer, (x,), strict=False)
            if not keep_kernels:
                program = program.run_decompositions(_plain_decompositions())
                left = kernel_op_counts(program)
                if left:
                    raise RuntimeError(f"portable program b{b}_t{t} still "
                                       f"holds kernel ops {left}")
            buf = io.BytesIO()
            torch.export.save(program, buf)
            z.writestr(f"b{b}_t{t}.pt2", buf.getvalue())
            seconds[(b, t)] = time.perf_counter() - t0
    return seconds


class ExportedEnhancer:
    """A loaded artifact: callable over numpy [B, T] float32 with automatic
    bucket selection (zero-pad up to the smallest covering shape, trim the
    output), every call under `torch.inference_mode()` on `device`.
    `programs[(B, T)]` is each shape's program (a torch.nn.Module taking a
    [B, T] tensor on `device`, returning (enhanced, mask_c))."""

    def __init__(self, meta: Dict, programs: Dict[Tuple[int, int], object],
                 device: torch.device):
        self.meta = meta
        self.programs = programs
        self.device = device
        self.shapes: List[Tuple[int, int]] = sorted(programs)

    def __call__(self, noisy: np.ndarray) -> np.ndarray:
        noisy = np.asarray(noisy, np.float32)
        b, t = noisy.shape
        fits = [(bb, tt) for bb, tt in self.shapes if bb >= b and tt >= t]
        if not fits:
            raise ValueError(f"no exported shape covers {noisy.shape}; have "
                             f"{self.shapes}")
        bb, tt = min(fits, key=lambda s: s[0] * s[1])
        padded = np.zeros((bb, tt), np.float32)
        padded[:b, :t] = noisy
        with torch.inference_mode():
            out, _mask = self.programs[(bb, tt)](
                torch.from_numpy(padded).to(self.device))
            return out[:b, :t].cpu().numpy()


def load_exported(path: str, device="cuda") -> ExportedEnhancer:
    """Load an artifact written by export_enhancer onto `device` (the card
    unless the caller asks for the CPU; raises when no card is visible).
    A keep_kernels artifact needs this package (its ops); a portable one
    loads with `torch.export.load` alone."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    # The programs' convs and matmuls are f32, as the enhancer's: no TF32.
    disable_tf32()
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json").decode())
        programs = {}
        for b, t in meta["shapes"]:
            program = torch.export.load(io.BytesIO(z.read(f"b{b}_t{t}.pt2")))
            programs[(b, t)] = move_to_device_pass(program, dev).module()
    return ExportedEnhancer(meta, programs, dev)

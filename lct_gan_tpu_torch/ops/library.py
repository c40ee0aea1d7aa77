"""The `torch.library` namespace of the port's kernels.

Each kernel is an operator `lct_gan_tpu_torch::<name>` whose schema is its
plain version's signature (every mode an argument, so a traced graph
carries it and nothing global is read at trace time): the CPU kernel is the
plain version, the CUDA kernel launches the hand-written CUDA kernel (and
counts the launch), and a fake implementation gives the output shapes, so
`torch.export` traces the operator as one node. The kernels are
registered on the dispatcher directly (`Library.impl`), the thinnest
route from a call to the Python kernel: each launch pays one dispatch.
"""

from __future__ import annotations

import torch

__all__ = ["NAMESPACE", "define_op"]

NAMESPACE = "lct_gan_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define_op(name: str, plain, cuda, fake):
    """Define `lct_gan_tpu_torch::<name>` with the schema of `plain`'s
    annotated signature (no argument mutated, outputs new tensors) and
    register its CPU kernel `plain`, its CUDA kernel `cuda` and its fake
    implementation `fake`. Returns the operator's default overload."""
    _LIB.define(name + torch.library.infer_schema(plain, mutates_args=()))
    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default

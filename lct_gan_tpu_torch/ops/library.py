"""The `torch.library` namespace of the port's kernels.

Each kernel is an operator `lct_gan_tpu_torch::<name>` whose schema is its
plain version's signature (every mode an argument, so a traced graph
carries it and nothing global is read at trace time): the CPU kernel is the
plain version, the CUDA kernel launches the hand-written CUDA kernel (and
counts the launch), and a fake implementation gives the output shapes, so
`torch.export` traces the operator as one node. The kernels are
registered on the dispatcher directly (`Library.impl`), the thinnest
route from a call to the Python kernel: each launch pays one dispatch.

The widths every CUDA kernel takes live here too (`CHANNELS`, `divisors`,
`check_kernel_widths`): each operator's checks and the model layer's
(`models/generator.py::check_card_widths`) call the one check.
"""

from __future__ import annotations

import torch

__all__ = ["NAMESPACE", "define_op", "CHANNELS", "divisors",
           "check_kernel_widths"]

NAMESPACE = "lct_gan_tpu_torch"

# The bottleneck widths the CUDA kernels take, forward and backward (each
# builds its own libraries, ops/_build.py), split into any number of
# attention heads or GRU groups that divides C (the JAX package's kernels
# read all three from their shapes).
CHANNELS = (16, 32, 48, 64, 96, 128)


def divisors(C: int) -> tuple:
    """Every head or group count that splits C channels evenly."""
    return tuple(n for n in range(1, C + 1) if C % n == 0)


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


def check_kernel_widths(what: str, C: int, *, num_heads=None, groups=None,
                        names=("C", "num_heads", "GRU groups"),
                        hint: str = "") -> None:
    """Raise unless the CUDA kernels take C channels (one of CHANNELS) in
    `num_heads` heads and `groups` GRU groups (each checked when given: a
    divisor of C). The message says "<what> takes ..." and names the three
    widths `names` (a kernel's own argument names, or the flags a user
    sets), then `hint`."""
    c_name, heads_name, groups_name = names
    if C not in CHANNELS:
        raise ValueError(f"{what} takes {c_name} in {CHANNELS}, got "
                         f"{c_name}={C}{hint}")
    for name, n in ((heads_name, num_heads), (groups_name, groups)):
        if n is not None and n not in divisors(C):
            raise ValueError(f"{what} takes {name} in {divisors(C)} "
                             f"(divisors of {C}), got {name} {n}{hint}")

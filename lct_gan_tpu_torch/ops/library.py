"""The `torch.library` namespace of the port's kernels.

Each kernel is an operator `lct_gan_tpu_torch::<name>` whose schema is its
plain version's signature (every mode an argument, so a traced graph
carries it and nothing global is read at trace time): the CPU kernel is the
plain version, the CUDA kernel launches the hand-written CUDA kernel (and
counts the launch), and a fake implementation gives the output shapes, so
`torch.export` traces the operator as one node. The kernels are
registered on the dispatcher directly (`Library.impl`), the thinnest
route from a call to the Python kernel: each launch pays one dispatch.

The widths every CUDA kernel takes live here too (`KERNEL_WIDTHS`,
`BACKWARD_WIDTHS`, `divisors`, `check_kernel_widths`): each operator's
checks and the model layer's (`models/generator.py::check_card_widths`)
call the one check.
"""

from __future__ import annotations

import functools

import torch

from lct_gan_tpu_torch.ops.padding import kernel_width, layout_width

__all__ = ["NAMESPACE", "define_op", "KERNEL_WIDTHS", "BACKWARD_WIDTHS",
           "divisors", "widest", "card_takes", "check_kernel_widths"]

NAMESPACE = "lct_gan_tpu_torch"

# The kernel widths the CUDA libraries are built for (one set of libraries
# each, ops/_build.py): the forward kernels at every one, the FTF backward
# at BACKWARD_WIDTHS (the same widths: a width's backward is built at its
# first backward). Any bottleneck width C in any number of attention heads
# and GRU groups that divides it runs at the one its padded layout fits
# (ops/padding.py::kernel_width), up to the widest (the JAX package's
# kernels read all three from their shapes): serving and training, whose
# gradients reach the backward kernel, up to 512 channels. A layout past
# 512 would need a kernel width of 1,024, past a block's 1,024 threads in
# the row kernels: it is refused by name.
KERNEL_WIDTHS = (16, 32, 64, 128, 256, 512)
BACKWARD_WIDTHS = (16, 32, 64, 128, 256, 512)


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


def widest(training: bool = False) -> int:
    """The widest kernel width: of the forward kernels, or with `training`
    of the FTF backward's."""
    return (BACKWARD_WIDTHS if training else KERNEL_WIDTHS)[-1]


@functools.lru_cache(maxsize=None)
def card_takes(C: int, num_heads: int = 1, groups: int = 1,
               training: bool = False) -> bool:
    """Whether the CUDA kernels take C channels in num_heads heads and
    `groups` GRU groups: both divide C and the padded layout's kernel width
    (ops/padding.py::kernel_width) is one of KERNEL_WIDTHS, or with
    `training` one of BACKWARD_WIDTHS (a gradient reaches the FTF backward
    kernel)."""
    return (C >= 1 and num_heads >= 1 and groups >= 1
            and C % num_heads == 0 and C % groups == 0
            and kernel_width(C, num_heads, groups) <= widest(training))


def check_kernel_widths(what: str, C: int, *, num_heads=None, groups=None,
                        names=("C", "num_heads", "GRU groups"),
                        hint: str = "", training: bool = False) -> None:
    """Raise unless the CUDA kernels take C channels in `num_heads` heads
    and `groups` GRU groups (each checked when given, as 1 when not:
    `card_takes`, with `training` the backward's widths): a count that does
    not divide C is refused by its name, a layout wider than the widest
    kernel by all three. The message says "<what> takes ..." and names the
    widths `names` (a kernel's own argument names, or the flags a user
    sets; None for one it has not), then `hint`."""
    nh, G = (1 if n is None else n for n in (num_heads, groups))
    if card_takes(C, nh, G, training):
        return
    c_name, heads_name, groups_name = names
    if C < 1:
        raise ValueError(f"{what} takes {c_name} >= 1, got {c_name}={C}"
                         f"{hint}")
    for name, n in ((heads_name, num_heads), (groups_name, groups)):
        if n is not None and n not in divisors(C):
            raise ValueError(f"{what} takes {name} in {divisors(C)} "
                             f"(divisors of {C}), got {name} {n}{hint}")
    given = [f"{c_name}={C}"] + [
        f"{name} {n}" for name, n in ((heads_name, num_heads),
                                      (groups_name, groups))
        if name is not None and n is not None]
    top = widest(training)
    raise ValueError(
        f"{what} takes widths whose padded layout fits {top} channels, got "
        f"{', '.join(given)}: the padded layout needs "
        f"{layout_width(C, nh, G)} channels "
        f"(> {top}){hint}")

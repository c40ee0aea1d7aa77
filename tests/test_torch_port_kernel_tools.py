"""The port's kernel tools that only run on the card, checked on the CPU as
far as they go there: the exp-rate probe (lct_gan_tpu_torch/ops/probe.py)
refuses a CPU device, and every build-time variant of the attention tuner
(lct_gan_tpu_torch/tune_attention.py) names a macro that csrc/tc.cuh really
takes, so no variant silently builds the defaults; likewise every
arithmetic variant of the banded-error diagnosis
(lct_gan_tpu_torch/banded_error.py) still edits csrc/banded.cu."""

import os
import re

import pytest

from lct_gan_tpu_torch import banded_error, tune_attention
from lct_gan_tpu_torch.ops import _build
from lct_gan_tpu_torch.ops.probe import ex2_rate


def test_ex2_rate_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA card"):
        ex2_rate(device="cpu")


def _tc_macros():
    with open(os.path.join(_build.CSRC_DIR, "tc.cuh"), encoding="utf-8") as f:
        src = f.read()
    return dict(re.findall(r"#ifndef (\w+)\n#define \1 (\d+)", src))


@pytest.mark.parametrize("name", sorted(tune_attention.VARIANTS))
def test_tune_variant_overrides_a_real_macro(name, monkeypatch):
    lib, defines = tune_attention.VARIANTS[name]
    macros = _tc_macros()
    assert lib in ("ftf", "mhsa") and defines
    for key in defines:
        assert key in macros, key
        assert key.startswith(f"LCT_{lib.upper()}_ATTN_")
    assert any(int(macros[k]) != v for k, v in defines.items())
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = tune_attention.nvcc_command(lib, defines, "/tmp/x.so")
    assert cmd[0] == "nvcc" and cmd[-1].endswith(f"csrc/{lib}.cu")
    assert [c for c in cmd if c.startswith("-D")] == [
        f"-D{k}={v}" for k, v in sorted(defines.items())]
    assert all(f in cmd for f in _build.NVCC_FLAGS)


def test_tune_defaults_are_the_committed_shapes():
    """The tuner's reference point is the build without overrides: FTF
    items of 64 rows; the register budgets and MHSA rows as tc.cuh sets
    them."""
    macros = _tc_macros()
    assert set(macros) == {"LCT_FTF_ATTN_ROWS", "LCT_FTF_ATTN_MIN_BLOCKS",
                           "LCT_MHSA_ATTN_ROWS", "LCT_MHSA_ATTN_MIN_BLOCKS"}
    assert macros["LCT_FTF_ATTN_ROWS"] == "64"
    assert all(int(v) > 0 for v in macros.values())


@pytest.mark.parametrize("name", sorted(banded_error.VARIANTS))
def test_banded_error_variant_edits_the_kernel(name):
    with open(os.path.join(_build.CSRC_DIR, "banded.cu"),
              encoding="utf-8") as f:
        committed = f.read()
    src = banded_error.variant_source(banded_error.VARIANTS[name])
    assert src != committed
    assert "banded_tc_kernel" in src

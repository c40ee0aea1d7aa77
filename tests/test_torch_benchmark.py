"""The port's benchmark (`benchmark/`, BENCHMARK.json) on the CPU.

(a) the analytic FLOP count behind mfu equals torch's FlopCounterMode over
    the plain reference functions called directly, at narrow widths, and
    reads the figures worked out for one 2 s row at the published widths;
    wrapped around the enhancer, FlopCounterMode misses the FTF operators;
(b) each cell's traffic, built from its BENCHMARK.json entry, is fixed by
    its seed, and the default seed gives `lct_gan_tpu_torch/bench.py`'s
    workloads;
(c) the plain reference (`benchmark/reference.py`) computes the port's
    function (against the port's all-f32 path), and each correctness check
    passes the port's bf16 path and fails a perturbed output, the
    fp8-operand control, and for the train step an unchanged state and a
    step on half the batch;
(d) the entry point exits non-zero, printing no result, without a CUDA
    device;
(e) BENCHMARK.json drives the harness: one configuration, three one-chip
    cells each on a loop the harness has, a bound below 100% for every
    end-to-end metric, layer metrics naming only existing cells;
and the metric's arithmetic (all audio over all seconds), the idle-gap
reading of a profiler trace, and that the benchmark imports no JAX.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import checks, flops, reference, run, traffic
from benchmark.trace import idle_gaps
from lct_gan_tpu_torch import bench as port_bench
from lct_gan_tpu_torch.convert import load_enhancer, read_npz_params
from lct_gan_tpu_torch.eval import make_enhance
from lct_gan_tpu_torch.models import attention as attention_module
from lct_gan_tpu_torch.models import generator as generator_module
from lct_gan_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                     MultiScaleDiscriminator)
from lct_gan_tpu_torch.models.generator import (FreqGRUBlock,
                                                LCTGeneratorConfig,
                                                LctEnhancer, TimeGRUBlock)
from lct_gan_tpu_torch.ops import (ftf_block_reference, grouped_gru_plain,
                                   mhsa_reference)
from lct_gan_tpu_torch.ops.ftf import MAX_FTF_SEQ
from lct_gan_tpu_torch.train import TrainConfig, create_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = run.load_spec()
CONFIG = SPEC["configs"]["lct_gan_c64_demo"]
CELLS = {w["name"]: w for w in SPEC["workloads"]}
WEIGHTS = os.path.join(ROOT, CONFIG["checkpoint"])
NARROW = flops.GeneratorWidths(enc_channels=(4, 8, 16),
                               dec_channels=(16, 8, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def counted_flops(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def narrow_enhancer():
    torch.manual_seed(0)
    return LctEnhancer(gen_cfg=LCTGeneratorConfig(
        enc_channels=NARROW.enc_channels, dec_channels=NARROW.dec_channels))


@pytest.fixture
def plain_ops(monkeypatch):
    """The generator's kernel wrappers replaced by their plain versions, so
    that FlopCounterMode sees inside them."""
    monkeypatch.setattr(generator_module, "fused_ftf_block",
                        ftf_block_reference)
    monkeypatch.setattr(generator_module, "fused_grouped_gru",
                        grouped_gru_plain)
    monkeypatch.setattr(attention_module, "fused_mhsa", mhsa_reference)


# (a) -------------------------------------------------------------------


@pytest.mark.parametrize("block,N,L", [(FreqGRUBlock, 6, 9),
                                       (TimeGRUBlock, 3, 13)])
def test_ftf_block_flops_equal_the_counter_on_the_reference(block, N, L):
    C = 16
    torch.manual_seed(0)
    mod = block(channels=C, num_heads=4, groups=4, precise=True)
    x = torch.randn(N, L, C)
    got = counted_flops(lambda: ftf_block_reference(
        x, *mod.kernel_params(), bidirectional=mod.bidirectional,
        num_heads=4))
    assert got == flops.ftf_block_flops(N, L, C, 4, mod.bidirectional)


def test_composed_time_block_flops_equal_the_counter(plain_ops):
    """Above MAX_FTF_SEQ the time block takes the composed path (GRU loop,
    MHSA, Linear); its count is the fused block's."""
    N, L, C = 2, MAX_FTF_SEQ + 3, 16
    torch.manual_seed(0)
    mod = TimeGRUBlock(channels=C, num_heads=4, groups=4, precise=True)
    x = torch.randn(N, L, C)
    got = counted_flops(lambda: mod._sequences(x))
    assert got == flops.ftf_block_flops(N, L, C, 4, False)


def test_enhancer_flops_equal_the_counter_and_the_counter_misses_the_ops(
        monkeypatch):
    enh = narrow_enhancer()
    x = torch.randn(2, 4000) * 0.1
    expect = flops.enhancer_flops(2, 4000, NARROW)
    wrapped = counted_flops(lambda: enh(x))
    monkeypatch.setattr(generator_module, "fused_ftf_block",
                        ftf_block_reference)
    assert counted_flops(lambda: enh(x)) == expect
    # Around the program the counter sees the convs only: the FTF blocks
    # are torch.library operators.
    assert wrapped < expect / 2


def test_published_width_figures():
    """One 2 s row at the published widths: 322,154,880 FLOPs of convs and
    349,823,232 + 367,259,904 + 349,823,232 of FTF blocks."""
    freq = flops.ftf_block_flops(129, 33, 64, 4, True)
    time = flops.ftf_block_flops(33, 129, 64, 4, False)
    assert (freq, time) == (349_823_232, 367_259_904)
    assert flops.enhancer_flops(1, 32000) == 322_154_880 + 2 * freq + time


@pytest.mark.parametrize("stack,count", [
    (MultiPeriodDiscriminator, flops.mpd_flops),
    (MultiScaleDiscriminator, flops.msd_flops)])
def test_discriminator_flops_equal_the_counter(stack, count):
    mod = stack(generator=torch.Generator().manual_seed(0))
    y = torch.randn(2, 701)     # not a multiple of any period
    assert counted_flops(lambda: mod(y)) == count(2, 701)


def test_train_step_and_mfu_arithmetic():
    d = flops.mpd_flops(16, 32000) + flops.msd_flops(16, 32000)
    assert flops.train_step_flops(8, 32000) == (
        3 * flops.enhancer_flops(8, 32000) + 6 * d)
    assert flops.mfu(989e12, 2.0) == pytest.approx(0.5)


# (b) -------------------------------------------------------------------


def test_default_seed_gives_the_port_bench_workloads():
    full = CELLS["full_utts_1p5_10s"]["traffic"]
    assert traffic.full_lengths(full) == port_bench.full_utterance_lengths()
    ours = traffic.full_batches(full)
    theirs, _ = port_bench.full_batches()
    assert len(ours) == len(theirs) == 12
    for (x, ln), (y, lm) in zip(ours, theirs):
        np.testing.assert_array_equal(ln, lm)
        np.testing.assert_array_equal(x, y)
    fixed = (0.1 * np.random.default_rng(1).standard_normal(
        (port_bench.BATCH, 32000))).astype(np.float32)
    np.testing.assert_array_equal(
        traffic.fixed_wave(CELLS["fixed_b128_2s"]["traffic"]), fixed)


@pytest.mark.parametrize("make", [
    lambda seed: traffic.fixed_wave(CELLS["fixed_b128_2s"]["traffic"], seed),
    lambda seed: np.asarray(traffic.full_lengths(
        CELLS["full_utts_1p5_10s"]["traffic"], seed)),
    lambda seed: traffic.full_batches(
        CELLS["full_utts_1p5_10s"]["traffic"], seed)[0][0],
    lambda seed: np.stack(traffic.train_batches(
        CELLS["train_b8_2s"]["traffic"], seed, 2)[1])])
def test_traffic_is_fixed_by_its_seed(make):
    np.testing.assert_array_equal(make(3), make(3))
    a, b = make(3), make(4)
    assert a.shape != b.shape or not np.array_equal(a, b)


def test_train_traffic_recipe():
    t = dict(CELLS["train_b8_2s"]["traffic"], rows=64)
    (noisy, clean), = traffic.train_batches(t, count=1)
    assert noisy.shape == clean.shape == (64, 32000)
    assert noisy.dtype == np.float32
    assert np.std(clean) == pytest.approx(0.1, rel=0.01)
    assert np.std(noisy - clean) == pytest.approx(0.05, rel=0.01)
    assert len(traffic.train_batches(CELLS["train_b8_2s"]["traffic"])) == (
        CELLS["train_b8_2s"]["traffic"]["pool"])


# (c) -------------------------------------------------------------------


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def ref_params():
    return reference.enhancer_params(WEIGHTS)


@pytest.fixture(scope="module")
def short_batch():
    """Four 0.5 s rows of the fixed cell's noise, and bucketed lengths."""
    x = torch.from_numpy(traffic.fixed_wave(
        CELLS["fixed_b128_2s"]["traffic"])[:4, :8000])
    return x, torch.tensor([8000, 5000, 3001, 6400])


def test_reference_computes_the_port_enhancer(ref_params, short_batch):
    """Against the port's all-f32 path, with and without lengths."""
    x, ln = short_batch
    enhance = make_enhance(load_enhancer(WEIGHTS, device="cpu",
                                         precise=True))
    with torch.no_grad():
        assert rel_err(enhance(x), reference.enhance(ref_params, x)[0]) < 1e-5
        got, ref = enhance(x, ln), reference.enhance(ref_params, x, ln)[0]
    for r, n in enumerate(ln.tolist()):
        assert rel_err(got[r, :n], ref[r, :n]) < 1e-5


def test_fixed_check(ref_params, short_batch):
    x, _ = short_batch
    out = make_enhance(load_enhancer(WEIGHTS, device="cpu"))(x)
    idx = [0, 2]
    with torch.no_grad():
        ref = reference.enhance(ref_params, x[idx])[0]
        ctrl = reference.enhance(ref_params, x[idx],
                                 bits=reference.CONTROL_BITS)[0]
    refs = dict(zip(idx, ref))
    res = checks.check_fixed(out, refs, (4, 8000))
    assert res["worst_rel_err"] < checks.TOL_WAVE / 1.5
    bad = out.clone()
    bad[idx] = ctrl
    got = checks.expect_rejected("fp8", checks.check_fixed, bad, refs,
                                 (4, 8000))
    assert got["worst_rel_err"] > 2 * checks.TOL_WAVE
    with pytest.raises(checks.CheckFailed):    # a control that passes
        checks.expect_rejected("program", checks.check_fixed, out, refs,
                               (4, 8000))
    bad = out.clone()
    bad[2, 100:200] *= 1.5
    with pytest.raises(checks.CheckFailed):
        checks.check_fixed(bad, refs, (4, 8000))
    bad = out.clone()
    bad[3, 7] = float("nan")    # a row that is not compared
    with pytest.raises(checks.CheckFailed):
        checks.check_fixed(bad, refs, (4, 8000))
    with pytest.raises(checks.CheckFailed):
        checks.check_fixed(out[:, :7999], refs, (4, 8000))


def test_full_check(ref_params, short_batch):
    x, ln = short_batch
    enhance = make_enhance(load_enhancer(WEIGHTS, device="cpu"))
    outs = [enhance(x[:2], ln[:2]), enhance(x[2:, :6400], ln[2:])]
    lengths = [ln[:2].numpy(), ln[2:].numpy()]
    refs, ctrls = {}, {}
    with torch.no_grad():
        for i, r, xb in ((0, 1, x[:2]), (1, 0, x[2:, :6400])):
            lens = torch.from_numpy(lengths[i][r:r + 1])
            refs[(i, r)] = reference.enhance(ref_params, xb[r:r + 1],
                                             lens)[0][0]
            ctrls[(i, r)] = reference.enhance(
                ref_params, xb[r:r + 1], lens,
                bits=reference.CONTROL_BITS)[0][0]
    res = checks.check_full(outs, lengths, refs)
    assert res["worst_rel_err"] < checks.TOL_WAVE / 1.5
    assert res["buckets_compared"] == 2 and res["true_samples"] == 22401
    bad = [o.clone() for o in outs]
    for (i, r), row in ctrls.items():
        bad[i][r] = row
    assert checks.expect_rejected("fp8", checks.check_full, bad, lengths,
                                  refs)["worst_rel_err"] > 2 * checks.TOL_WAVE
    bad = [o.clone() for o in outs]
    bad[1][0, 1000:1400] *= 1.5
    with pytest.raises(checks.CheckFailed):
        checks.check_full(bad, lengths, refs)
    bad = [o.clone() for o in outs]
    bad[1][0, 3000] = float("inf")     # the last true sample of a row
    with pytest.raises(checks.CheckFailed):
        checks.check_full(bad, lengths, refs)
    bad[1][0, 3000] = outs[1][0, 3000]
    bad[1][0, 3001] = float("nan")     # padding: trimmed away
    checks.check_full(bad, lengths, refs)


@pytest.fixture(scope="module")
def train_case():
    """A seeded state (demo generator, seeded MPD and MSD) after three
    steps of the port, so that AdamW has moments to weigh a gradient
    against, a copy of it on the all-f32 path, and a B = 2 x 0.125 s
    batch."""
    cfg = TrainConfig()
    g_params, _ = read_npz_params(WEIGHTS)
    t = dict(CELLS["train_b8_2s"]["traffic"], rows=2, samples=2000)
    *warm, (noisy, clean) = [(torch.from_numpy(a), torch.from_numpy(b))
                             for a, b in traffic.train_batches(t, count=4)]
    states = {}
    for precise in (False, True):
        states[precise] = create_state(
            cfg, torch.Generator().manual_seed(0), device="cpu",
            precise=precise, g_params=g_params)
    step = make_train_step(cfg)
    for batch in warm:
        step(states[False], *batch)
    for name in ("enhancer", "mpd", "msd", "g_opt", "d_opt"):
        # A deep copy: the optimizers' step counters are shared tensors.
        getattr(states[True], name).load_state_dict(
            copy.deepcopy(getattr(states[False], name).state_dict()))
    before, moments = reference.state_tensors(states[False])
    ref, noise = (reference.train_step(before, moments, noisy, clean, cfg,
                                       bits=bits)
                  for bits in (None, reference.PROGRAM_BITS))
    return cfg, states, before, moments, ref, noise, noisy, clean


def port_step(cfg, state, noisy, clean):
    metrics = {k: float(v) for k, v in
               make_train_step(cfg)(state, noisy, clean).items()}
    return metrics, reference.state_tensors(state)[0]


def test_reference_computes_the_port_train_step(train_case):
    """Against the port's all-f32 step from the same state: the same
    losses (to f32 rounding: the mask loss's IRM divides by the noisy
    STFT's smallest bins) and parameter changes."""
    cfg, states, before, _, (ref_m, ref_after), _, noisy, clean = (
        train_case)
    metrics, after = port_step(cfg, states[True], noisy, clean)
    for k in ref_m:
        assert metrics[k] == pytest.approx(ref_m[k], rel=1e-4), k
    held, _ = checks.delta_errors(before, after, ref_after)
    assert max(held.values()) < checks.TOL_DELTA / 10


def test_train_check(train_case):
    cfg, states, before, moments, ref, noise, noisy, clean = train_case
    metrics, after = port_step(cfg, states[False], noisy, clean)
    res = checks.check_train(metrics, ref, noise, before, after)
    assert res["worst_delta_in_noise"] < checks.TOL_DELTA / 2
    assert res["worst_loss_in_noise"] < checks.TOL_LOSS / 2
    # Three in-projection biases, each held as its q and v thirds.
    assert res["leaves"] == len(before) + 3

    def rejected(what, m, a):
        return checks.expect_rejected(what, checks.check_train, m, ref,
                                      noise, before, a)

    got = rejected("fp8", *reference.train_step(
        before, moments, noisy, clean, cfg, bits=reference.CONTROL_BITS))
    assert got["worst_delta_in_noise"] > 2 * checks.TOL_DELTA
    got = rejected("unchanged", metrics, before)
    assert got["worst_delta_rel_err"] == pytest.approx(1.0)
    assert got["worst_delta_in_noise"] > 10 * checks.TOL_DELTA
    got = rejected("half", *reference.train_step(before, moments, noisy[:1],
                                                 clean[:1], cfg))
    assert got["worst_delta_in_noise"] > 10 * checks.TOL_DELTA
    nan = dict(metrics, d_loss=float("nan"))
    with pytest.raises(checks.CheckFailed):
        checks.check_train(nan, ref, noise, before, after)


# (d) -------------------------------------------------------------------


def test_exits_nonzero_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main([])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_imports_no_jax():
    code = ("import sys, benchmark.run, benchmark.reference, "
            "lct_gan_tpu_torch.convert, lct_gan_tpu_torch.eval, "
            "lct_gan_tpu_torch.train, lct_gan_tpu_torch.ops._build, "
            "lct_gan_tpu_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'lct_gan_tpu')]; "
            "sys.exit(', '.join(bad) or None)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# (e) -------------------------------------------------------------------


def test_benchmark_json_matches_the_code():
    """Every cell runs on a loop of the harness with the keys it reads."""
    assert list(SPEC["configs"]) == ["lct_gan_c64_demo"]
    assert len(CONFIG["source"]) <= 200
    assert CONFIG["reduced"] == []
    assert os.path.isfile(WEIGHTS)
    TrainConfig(**CONFIG["train_config"])
    assert tuple(CELLS) == ("fixed_b128_2s", "full_utts_1p5_10s",
                            "train_b8_2s")
    for w in CELLS.values():
        assert w["chips"] == 1 and w["config"] in SPEC["configs"]
        assert w["loop"] in run.LOOPS
        assert {"warmup_passes", "min_passes", "window_s"} <= set(w["timing"])
        assert w["timing"]["min_passes"] >= 5
        assert w["name"] in SPEC["metrics"][w["metric"]]["workloads"]
        assert set(w["kernels"]) <= {f.__name__ for f in run.wrappers()}
    for name, m in SPEC["metrics"].items():
        assert isinstance(m["regression_bound"], float), name
        assert 0.02 <= m["regression_bound"] < 1.0, name
        assert set(m["workloads"]) <= set(CELLS), name
    for group in ("layer_metrics", "derived"):
        for name, m in SPEC[group].items():
            assert m["workloads"] and set(m["workloads"]) <= set(CELLS), name
    assert CONFIG["generator"]["enc_channels"] == list(
        flops.PUBLISHED.enc_channels)


def test_metric_is_all_audio_over_all_seconds(monkeypatch):
    """Passes go on until both min_passes and window_s are reached; the
    metric is their audio over their summed seconds, not a median."""
    seconds = iter([1.0, 3.0, 1.0, 1.0, 4.0, 9.0])
    monkeypatch.setattr(run, "timed", lambda fn: next(seconds))
    res = run.measure(lambda: None, {"min_passes": 3, "window_s": 8.0},
                      "m", 2.0, int(989e12))
    assert res["metric"]["passes"] == 5
    assert res["metric"]["value"] == pytest.approx(10.0 / 10.0)
    assert res["metric"]["per_pass"]["median"] == pytest.approx(2.0)
    assert res["mfu"] == pytest.approx(5 / 10.0)
    assert "tail" not in res["metric"]["per_pass"]
    seconds = iter([float(s) for s in range(1, 13)])
    res = run.measure(lambda: None, {"min_passes": 12, "window_s": 0.0},
                      "m", 2.0, 1)
    # Ten passes (3 s to 12 s) are slower than the 2 s pass.
    assert res["metric"]["per_pass"]["tail"] == {
        "rate": 1.0, "percentile": pytest.approx(100 * 2 / 12)}


def test_idle_gaps_of_a_trace():
    """Device busy 10-35 and 60-90 us of a 0-100 us span: idle 45%, the
    gaps 25 (under aten::mm), 10 and 10 us."""
    events = [
        {"name": "benchmark_pass", "cat": "user_annotation", "ts": 0,
         "dur": 100},
        {"name": "k1", "cat": "kernel", "ts": 10, "dur": 20, "tid": 7},
        {"name": "k2", "cat": "kernel", "ts": 25, "dur": 10, "tid": 8},
        {"name": "m", "cat": "gpu_memcpy", "ts": 60, "dur": 30},
        {"name": "outer", "cat": "cpu_op", "ts": 0, "dur": 99},
        {"name": "aten::mm", "cat": "cpu_op", "ts": 36, "dur": 20}]
    res = idle_gaps(events, "benchmark_pass", top=2)
    assert res["device_idle_share"] == pytest.approx(0.45)
    assert res["device_busy_ms"] == pytest.approx(0.055)
    assert res["device_streams"] == 2
    assert [g["ms"] for g in res["longest_idle_gaps"]] == pytest.approx(
        [0.025, 0.010])
    assert res["longest_idle_gaps"][0] == {"ms": pytest.approx(0.025),
                                           "at_ms": pytest.approx(0.035),
                                           "host_op": "aten::mm"}

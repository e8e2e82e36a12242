"""The metric arithmetic: window rates, statistics of the gaps, the busy
union of a trace, and B1's operations and bytes against a hand count."""

import math

import pytest
import torch

from benchmark.harness import compare, manifest, spread, trace as tr, work

ROOT = manifest.ROOT


def reader(name):
    return manifest.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_window_rates():
    rec = {"window_s": 40.0, "units": 400, "batch": 1, "ticks_per_unit": 1, "setup_s": 12.5}
    assert reader("tick_ms").read(rec) == pytest.approx(100.0)
    assert reader("setup_s").read(rec) == 12.5
    sweep = {"window_s": 48.0, "units": 4, "batch": 4096, "ticks_per_unit": 40}
    assert reader("scenario_ticks_per_s").read(sweep) == pytest.approx(4096 * 40 * 4 / 48.0)
    srbd = {"window_s": 40.0, "units": 500, "batch": 4096, "ticks_per_unit": 1}
    assert reader("mpc_solves_per_s").read(srbd) == pytest.approx(4096 * 500 / 40.0)


def test_gap_statistics():
    g = compare.Gaps()
    g.add("x", torch.tensor([[0.0, 1.0], [2.0, 2.0], [5.0, 5.0], [1.0, 1.0]]),
          torch.tensor([[0.0, 0.5], [2.0, 2.1], [0.0, 5.0], [1.0, 1.0]]))
    rows = g.all("x")
    assert rows.tolist() == pytest.approx([0.5, 0.1, 5.0, 0.0])
    assert g.value("x.max") == 5.0
    assert g.value("x.share_gt_0.2") == 50.0
    assert g.value("x.share_gt_0.01") == 75.0
    g.add("y", torch.tensor([[float("nan")]]), torch.tensor([[1.0]]))
    assert g.value("y.max") == math.inf
    ok, rows = compare.judge(g, {"x.max": 5.0, "x.share_gt_0.2": 50.0})
    assert ok
    ok, _ = compare.judge(g, {"x.max": 4.9})
    assert not ok
    assert not compare.judge(g, {})[0]
    assert not compare.judge(g, {"z.max": 1.0})[0]


def test_quartile_spread():
    assert spread.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def _trace(device, window, spans=(), ops=()):
    return tr.Trace(sorted(device), sorted(ops), sorted(spans), window)


def test_busy_union_and_counts():
    t = _trace([(0, 10, "k1"), (5, 20, "k2"), (30, 40, "Memcpy HtoD"), (95, 120, "k3")],
               (0, 100))
    assert tr.busy_s(t) == pytest.approx((20 + 10 + 5) / 1e9)
    assert tr.window_s(t) == pytest.approx(100 / 1e9)
    assert tr.kernel_count(t) == 3
    rec = {"trace": t, "units": 2, "ticks_per_unit": 1}
    assert reader("device_idle_pct.serving").read(rec) == pytest.approx(65.0)
    assert reader("kernels_per_tick.serving").read(rec) == pytest.approx(1.5)
    assert reader("device_busy_ms.srbd").read(rec) == pytest.approx(1e3 * 35e-9 / 2)
    assert reader("device_idle_pct.sweep").read({"trace": None}) is None


def test_idle_gaps_by_host_span():
    t = _trace([(0, 10, "k"), (60, 100, "k")], (0, 100),
               spans=[(0, 50, "bench.step"), (50, 100, "bench.measure")],
               ops=[(10, 58, "aten::copy_"), (20, 30, "aten::item")])
    gaps = dict(tr.idle_gaps(t))
    assert gaps == {"step: aten::copy_": pytest.approx(50 / 1e9)}


def test_b1_work_hand_count():
    # (4096, 30, 30) float32: K read and W written once, 2 n^3 / 3 flops each.
    nbytes, flops = work.b1_work(4096, 30, 4)
    assert nbytes == 2 * 4096 * 900 * 4
    assert flops == 4096 * 2 * 27000 / 3
    bound = work.b1_bound_s(4096, 30, torch.float32)
    assert bound == pytest.approx(nbytes / 3.35e12)  # bandwidth-bound: 8.8 us
    assert bound == pytest.approx(8.80e-6, rel=1e-3)


def test_b1_roofline_reader():
    launches = [(4096, 30, torch.float32), (4096, 30, torch.float32)]
    t = _trace([(0, 20000, "void chol_inv_base_kernel<float, 30>(...)"),
                (30000, 50000, "void chol_inv_base_kernel<float, 30>(...)"),
                (50000, 60000, "gemm")], (0, 100000))
    rec = {"trace": t, "b1_launches": launches}
    pct = reader("b1_roofline.srbd").read(rec)
    assert pct == pytest.approx(100 * 2 * work.b1_bound_s(4096, 30, torch.float32) / 40e-6)
    # A launch the trace lacks: nothing to read.
    assert reader("b1_roofline.srbd").read(dict(rec, b1_launches=launches * 2)) is None


def test_op_kinds():
    assert tr.op_kind("void chol_inv_base_kernel<float, 30>") == "B1"
    assert tr.op_kind("sm90_xmma_gemm_f32f32") == "cuBLAS"
    assert tr.op_kind("Memcpy DtoH (Device -> Pinned)") == "copy"
    assert tr.op_kind("void at::native::elementwise_kernel") == "other elementwise / reduction"

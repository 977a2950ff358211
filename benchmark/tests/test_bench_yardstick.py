"""The frozen arithmetic on hand-counted calls, and the roofline and idle
readers on synthetic traces."""

import importlib.util
import os

import pytest
import torch

from benchmark import yardstick as Y
from conftest import ROOT


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_takes_the_longer_side():
    assert Y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert Y.bound_s(0, 67e12) == pytest.approx(1.0)
    assert Y.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_fused_bound_by_hand():
    # 10 live of 64 pixels, 40 samples each, 5 spheres (the emitter one of
    # them), 1 plane, 33 scene scalars
    per = 79 + 4 * 53.13 + 2 * 4 + 2 * 35.74 + 159.61    # 530.61
    ops = 400 * (per + 30 * 4 + 25 * 1)
    need = 4 * (2 * 400 + 64 + 16 * 10 + 33 + 3 * 64)
    assert ops / 67e12 > need / 3.35e12
    assert Y.fused_bound_s(400, 64, 10, 33, 5, 1) == pytest.approx(
        ops / 67e12)


def test_visit_bound_by_hand():
    # R 2048 rays (2000 live) against K 6300 boxes, V 88
    ops = 25 * 2000 * 6300
    need = 4 * (6 * 2048 + 6 * 6300 + 2 * 2048 * 88 + 2048)
    assert Y.visit_bound_s(2048, 6300, 88, 2000) == pytest.approx(
        max(ops / 67e12, need / 3.35e12))
    # bytes win when the rays are few and the lists long
    assert Y.visit_bound_s(8, 10, 10, 0) == pytest.approx(
        4 * (48 + 60 + 160 + 8) / 3.35e12)


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert Y.union_s(iv) == pytest.approx(25e-9)
    assert Y.union_s([]) == 0.0


def test_idle_gaps_by_host_op():
    device = [(0, 10, "k1"), (30, 40, "k2"), (45, 50, "k1"),
              (100, 110, "k3")]
    host = [(-5, 0, "aten::a"), (12, 31, "aten::b"), (41, 44, "aten::c"),
            (60, 95, "aten::b")]
    gaps = dict(Y.idle_gaps(device, host))
    # gaps 10-30 (b issuing), 40-45 (c), 50-100 (b)
    assert gaps == pytest.approx({"aten::b": 70e-9, "aten::c": 5e-9})
    ops = dict(Y.device_ops(device))
    assert ops["k1"] == pytest.approx(15e-9)


def test_idle_reader():
    r = reader("device_idle.frame")
    assert r.read({"iteration": "frame", "busy_s": 0.25,
                   "span_s": 1.0}) == 0.75
    assert r.read({"iteration": "step", "busy_s": 0.25,
                   "span_s": 1.0}) is None
    assert reader("launches.step").read(
        {"iteration": "step", "n": 4,
         "device_events": [(0, 1, "k")] * 10}) == 2.5


def test_fused_roofline_reader():
    r = reader("k2_fused_shadow_roofline")
    px = torch.zeros(17, 64)
    px[16, :10] = 1.0
    call = r._keep(torch.zeros(2, 40, 64), px, torch.zeros(33), 200, lc=40,
                   ns=5, npl=1, egid=3, phong=True, atten_kind="sqr")
    bound = Y.fused_bound_s(400, 64, 10, 33, 5, 1)
    events = [(0, 1000, "fused_shadow_kernel(...)"), (0, 5000, "other")]
    # the call keeps counts only, no reference to the program's tensors
    assert call == (10, 64, 200, 40, 33, 5, 1)
    got = r.read({"calls": [call, call], "device_events": events})
    assert got == pytest.approx(100 * 2 * bound / 1e-6)
    # nothing to read: no calls, or no kernel in the trace
    assert r.read({"calls": [], "device_events": events}) is None
    assert r.read({"calls": [call], "device_events": events[1:]}) is None


def test_visit_roofline_reader():
    r = reader("k3_visit_order_roofline")
    o = torch.zeros(8, 3)
    o[2] = float("inf")
    d = torch.ones(8, 3)
    d[5, 1] = float("nan")
    call = r._keep(o, d, torch.zeros(10, 3), torch.ones(10, 3), 4)
    assert call == (8, 10, 4, 6)
    events = [(0, 500, "visit_order_kernel<...>"),
              (600, 1100, "visit_order_kernel<...>")]
    got = r.read({"calls": [call], "device_events": events})
    assert got == pytest.approx(100 * Y.visit_bound_s(8, 10, 4, 6) / 1e-6)


@pytest.mark.parametrize("alias,same", [
    ("launches.gi", "launches.frame"),
    ("device_idle.gi", "device_idle.frame"),
    ("k2_fused_shadow_roofline.gi", "k2_fused_shadow_roofline")])
def test_gi_readers_read_alike(alias, same):
    a, b = reader(alias), reader(same)
    assert ([w[:2] for w in getattr(a, "WRAPS", ())]
            == [w[:2] for w in getattr(b, "WRAPS", ())])
    px = torch.zeros(17, 64)
    px[16, :10] = 1.0
    ctx = {"iteration": "frame", "n": 2, "busy_s": 0.25, "span_s": 1.0,
           "calls": [(10, 64, 200, 40, 33, 5, 1)],
           "device_events": [(0, 1000, "fused_shadow_kernel(...)"),
                             (0, 5000, "other")]}
    assert a.read(ctx) == b.read(ctx) is not None
    assert a.read({**ctx, "iteration": "step"}) == b.read(
        {**ctx, "iteration": "step"})


def test_traced_frame_seconds_reader():
    r = reader("frame_s.gi")
    assert r.read({"iteration": "frame", "n": 4, "span_s": 6.0}) == 1.5
    # an untraced window has no traced span
    assert r.read({"iteration": "frame", "n": 4, "window_s": 6.0}) is None
    assert r.read({"iteration": "step", "n": 4, "span_s": 6.0}) is None

"""The port's spans and counters (``c_raytracer_tpu_torch/core/tracing.py``)
on the CPU: off, nothing is kept and no profiler range is entered; under
``torch.profiler`` the spans nest frame ⊃ tile ⊃ round ⊃ intersection and
shading, the counters count what their sites do, the records sit on the
profiler's clock, and the readers of the benchmark's per-layer metrics
(``benchmark/metrics/``) return the values computed by hand from synthetic
traces.  The ray statistics, now computed only under ``with_stats``, equal
the values the integrator gave before that change.
"""

import functools
import os

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import core, program_spans
from c_raytracer_tpu_torch.accel import intersect, reorder_scene, traverse
from c_raytracer_tpu_torch.core import tracing
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import load_scene, make_scene
from c_raytracer_tpu_torch.scene.convert import named_leaves, params_to_torch
from test_torch_union_render import glass_soup_kwargs

pytest_plugins = ("torch_harness",)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = os.path.join(ROOT, "scenes", "spheres_opaque.json")
DENSE_CFG = RenderConfig(tile_size=128)          # 16² in two tiles
GLASS_CFG = RenderConfig(max_bounces=1)          # 8²

# the integrator's stats before they were gated on ``with_stats``: the
# dense 16² frame and the glass soup's 8² frame at seed 7
PARENT_STATS = {
    "dense": {"main_rays": 279.0, "shadow_rays": 28000.0, "gi_rays": 0.0,
              "children_pushed": 23.0, "dropped": 0.0,
              "shadow_spill_max": 0.0, "visit_spill_max": 0.0},
    "glass": {"main_rays": 95.0, "shadow_rays": 1424.0, "gi_rays": 0.0,
              "children_pushed": 31.0, "dropped": 0.0,
              "shadow_spill_max": 0.0, "visit_spill_max": 0.0},
}


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def dense():
    return load_scene(DENSE)


@functools.lru_cache(maxsize=None)
def glass():
    return reorder_scene(make_scene(**glass_soup_kwargs()))


def traced_frame(scene, cfg, res, seed=7, **kw):
    """One frame under the profiler (CPU): (out, records, profiler)."""
    fn = make_renderer(scene.static, cfg, res, res, device="cpu", **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(scene.params, PhiloxSampler(seed, "cpu"))
    recs = tracing.records()
    tracing.reset()
    return out, recs, prof


def spied(owner, name, spy):
    """``owner.name`` replaced by ``spy(real)`` while the context is open."""
    class Spied:
        def __enter__(self):
            self.real = getattr(owner, name)
            setattr(owner, name, spy(self.real))

        def __exit__(self, *exc):
            setattr(owner, name, self.real)
    return Spied()


@functools.lru_cache(maxsize=None)
def dense_traced():
    """The dense 16² frame under the profiler, shared by the tests that read
    it: (out, records, profiler, ``live.any()`` reads).  A read is a call
    of ``any()`` without arguments on a 1-D bool tensor."""
    reads = []

    def spy(real):
        def any_(self, *a, **k):
            if self.dtype == torch.bool and self.dim() == 1 and not a:
                reads.append(1)
            return real(self, *a, **k)
        return any_
    with spied(torch.Tensor, "any", spy):
        out, recs, prof = traced_frame(dense(), DENSE_CFG, 16)
    return out, recs, prof, len(reads)


@functools.lru_cache(maxsize=None)
def glass_traced():
    """The glass soup's 8² frame under the profiler: (out, records, the
    (``steps`` counter, visit steps) of each ``any_hit_tint_shared``
    call, its visit steps computed from its own lists, the number of
    ``shadow_query`` calls)."""
    calls, queries = [], []

    def spy_query(real):
        def shadow_query(self, *a, **k):
            queries.append(1)
            return real(self, *a, **k)
        return shadow_query

    def spy(real):
        def shared(cs, origin, cids, ok, dirs_fn, nchunks, acc, *,
                   dead_skip=False, steps=None):
            calls.append((steps, ok.shape[1] if not dead_skip or not len(ok)
                          else int(ok.sum(1).max())))
            return real(cs, origin, cids, ok, dirs_fn, nchunks, acc,
                        dead_skip=dead_skip, steps=steps)
        return shared
    with spied(traverse, "any_hit_tint_shared", spy), \
            spied(intersect.Intersector, "shadow_query", spy_query):
        out, recs, _ = traced_frame(glass(), GLASS_CFG, 8)
    return out, recs, calls, len(queries)


def ancestors(rec, by_id):
    out = []
    while rec.parent is not None:
        rec = by_id[rec.parent]
        out.append(rec.name)
    return out


# -- off -------------------------------------------------------------------

def test_off_keeps_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(tracing, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sc = dense()
    img, z = make_renderer(sc.static, DENSE_CFG, 8, 8, device="cpu")(
        sc.params, PhiloxSampler(7, "cpu"))
    assert tracing.records() == [] and tracing.totals() == {}
    assert not tracing.enabled()


def test_off_span_is_the_shared_noop():
    assert tracing.span("round", index=3) is tracing.span("frame")
    with tracing.span("intersect.closest") as got:
        tracing.count("rounds", 4)
    assert got is None and tracing.totals() == {}


def test_enable_and_reset():
    tracing.enable()
    with tracing.span("frame") as rec:
        tracing.count("sync.x", 2)
        with tracing.span("round", index=1):
            tracing.count("rounds")
    tracing.count("sync.x")   # no span open: kept apart
    recs = tracing.records()
    assert [r.name for r in recs] == ["crt.frame", "crt.round"]
    assert recs[1].parent == rec.id and recs[1].attrs == {"index": 1}
    assert [r.layer for r in recs] == ["entry", "integrator"]
    assert recs[0].counts == {"sync.x": 2} and recs[1].counts == {
        "rounds": 1}
    assert tracing.totals() == {"sync.x": 3, "rounds": 1}
    assert tracing.totals(recs) == {"sync.x": 2, "rounds": 1}
    tracing.reset()
    assert tracing.records() == [] and tracing.totals() == {}


def test_on_only_while_the_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
    assert not tracing.enabled()


# -- on: the spans and counters of frames ---------------------------------

def test_dense_frame_nesting():
    _, recs, _, _ = dense_traced()
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    assert names.count("crt.frame") == 1 and names.count("crt.tile") == 2
    for r in recs:
        if r.name in ("crt.intersect.closest", "crt.shade.chunk"):
            up = ancestors(r, by_id)
            assert up[-3:] == ["crt.round", "crt.tile", "crt.frame"], up
    for r in recs:
        assert r.end >= r.start and r.frame == 1
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start <= r.start and r.end <= p.end
    assert {r.layer for r in recs} == {"entry", "integrator", "intersect",
                                       "shade"}


def test_dense_round_syncs_count_the_any_reads():
    """``sync.round_any`` is the number of ``live.any()`` reads: the rounds
    run, and one more in a tile whose loop broke early."""
    _, recs, _, reads = dense_traced()
    counts = tracing.totals(recs)
    rounds = [r for r in recs if r.name == "crt.round"]
    broke = sum(1 for r in rounds if "rounds" not in r.counts)
    assert counts["sync.round_any"] == reads == len(rounds)
    assert counts["rounds"] == len(rounds) - broke
    max_rounds = DENSE_CFG.max_bounces + 1
    for t in (r for r in recs if r.name == "crt.tile"):
        mine = [r for r in rounds if r.parent == t.id]
        ran = sum(r.counts.get("rounds", 0) for r in mine)
        assert len(mine) == ran + (ran < max_rounds)
        assert [r.attrs["index"] for r in mine] == list(range(len(mine)))


def test_glass_union_blocks_and_steps():
    """The glass soup's union sweep: one block a union shadow query, with
    a span and a ``union_blocks`` count, ``union_steps`` the slot loop's
    iterations."""
    _, recs, calls, queries = glass_traced()
    by_id = {r.id: r for r in recs}
    counts = tracing.totals(recs)
    blocks = [r for r in recs if r.name == "crt.intersect.union_block"]
    assert len(blocks) == queries >= 2
    assert counts["union_blocks"] == len(blocks) == len(calls)
    assert len({b.parent for b in blocks}) == len(blocks)
    assert all(s == "union_steps" for s, _ in calls)
    assert counts["union_steps"] == sum(n for _, n in calls) > 0
    for b in blocks:
        up = ancestors(b, by_id)
        assert up[0] == "crt.intersect.shadow" and "crt.shade.emitter" in up
        assert "crt.round" in up
    assert counts["sync.visit_limit"] >= len(blocks)
    assert counts["sync.round_any"] >= counts["rounds"] > 0
    assert "crt.intersect.retest" in {r.name for r in recs}


def test_gi_sample_counts():
    """Path GI at spp 2: both samples at the primary round, one of the
    two after it (the other skipped)."""
    cfg = RenderConfig(tile_size=64, gi_model="path", samples_per_pixel=2,
                       max_bounces=2)
    _, recs, _ = traced_frame(dense(), cfg, 8)
    counts = tracing.totals(recs)
    tiles = [r for r in recs if r.name == "crt.tile"]
    rounds = counts["rounds"]
    assert counts["gi.samples_run"] == 2 * len(tiles) + (rounds - len(tiles))
    assert counts["gi.samples_skipped"] == rounds - len(tiles)
    assert sum(r.name == "crt.gi.sample" for r in recs) == counts[
        "gi.samples_run"]


def test_dense_step_recomputes():
    sc = dense()
    p = params_to_torch(sc.params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    fn = make_renderer(sc.static, RenderConfig(tile_size=64), 8, 8,
                       device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        img, _ = fn(p, PhiloxSampler(3, "cpu"))
        img.square().mean().backward()
    recs = tracing.records()
    rec = [r for r in recs if r.name == "crt.remat.recompute"]
    assert rec and all(r.layer == "backward" for r in rec)
    frame = next(r for r in recs if r.name == "crt.frame")
    assert all(r.start >= frame.end for r in rec)
    # the recomputed regions show their own spans inside the recompute
    by_id = {r.id: r for r in recs}
    inner = [r for r in recs if r.parent is not None
             and by_id[r.parent].name == "crt.remat.recompute"]
    assert {r.name for r in inner} >= {"crt.intersect.closest",
                                      "crt.shade.emitter"}


def test_records_on_the_profilers_clock():
    """At least 99% of the records start and end within 50 µs of the
    profiler's event of the same span."""
    _, recs, prof, _ = dense_traced()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("crt."):
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                     e.end_ns()))
    diffs = []
    for name, evs in events.items():
        mine = sorted((r.start, r.end) for r in recs if r.name == name)
        assert len(mine) == len(evs), name
        diffs += [max(abs(a - c), abs(b - d))
                  for (a, b), (c, d) in zip(mine, sorted(evs))]
    assert len(diffs) == len(recs)
    assert sum(d <= 50_000 for d in diffs) >= 0.99 * len(diffs)


@pytest.mark.parametrize("which", ["dense", "glass"])
def test_stats_unchanged(which):
    """With ``with_stats`` the counts are the integrator's from before the
    gate; the image is the traced frame's without stats, bit for bit."""
    sc, cfg, res, traced = ((dense(), DENSE_CFG, 16, dense_traced)
                            if which == "dense"
                            else (glass(), GLASS_CFG, 8, glass_traced))
    img, z, st = make_renderer(sc.static, cfg, res, res, device="cpu",
                               with_stats=True)(sc.params,
                                                PhiloxSampler(7, "cpu"))
    assert {k: float(v) for k, v in st.items()} == PARENT_STATS[which]
    img2, z2 = traced()[0]
    assert torch.equal(img, img2) and torch.equal(z, z2)


def test_comm_spans(monkeypatch):
    from c_raytracer_tpu_torch.core import comm
    monkeypatch.setattr(comm.dist, "all_reduce", lambda x, **k: None)
    monkeypatch.setattr(comm.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(comm.dist, "all_gather",
                        lambda parts, x, **k: [p.copy_(x) for p in parts])
    tracing.enable()
    comm.all_reduce_sum(torch.ones(3), None)
    out = comm.gather(torch.ones(2), None)
    assert out.shape == (2, 2)
    assert [r.name for r in tracing.records()] == ["crt.comm.all_reduce",
                                                    "crt.comm.gather"]
    assert {r.layer for r in tracing.records()} == {"comm"}
    assert tracing.totals() == {"comm.calls": 2}


# -- the readers of the per-layer metrics ---------------------------------

def rec(name, start, end, counts=None, parent=None, thread=1):
    r = tracing.Record()
    r.name = tracing.PREFIX + name
    r.layer = tracing.LAYERS[name.split(".")[0]]
    r.id, r.parent, r.thread, r.frame = start, parent, thread, 1
    r.start, r.end, r.attrs, r.counts = start, end, {}, dict(counts or {})
    return r


def reader(name):
    return core.reader(ROOT, name)


@pytest.fixture
def records(monkeypatch):
    """Install synthetic records as the program's."""
    def put(recs):
        monkeypatch.setattr(tracing, "_records", list(recs))
    return put


# a window of host operations from 100 to 10,000 ns
HOST = [(100, 200, "aten::mul"), (5000, 10_000, "aten::add")]


def ctx(iteration, n=2, device=None):
    return dict(iteration=iteration, n=n, host_events=HOST,
                device_events=device or [(0, 1, "k")])


@pytest.mark.parametrize("name,iteration", [("host_syncs.frame", "frame"),
                                            ("host_syncs.step", "step")])
def test_reader_host_syncs(records, name, iteration):
    records([rec("frame", 50, 9000, {"sync.a": 1}),
             rec("round", 300, 800, {"sync.round_any": 3, "rounds": 2}),
             rec("remat.recompute", 9500, 9800, {"sync.visit_limit": 4}),
             rec("round", 20_000, 30_000, {"sync.round_any": 100})])
    assert reader(name).read(ctx(iteration)) == (1 + 3 + 4) / 2
    other = "step" if iteration == "frame" else "frame"
    assert reader(name).read(ctx(other)) is None


def test_reader_union_steps(records):
    records([rec("intersect.union_block", 300, 400,
                 {"union_steps": 7, "union_blocks": 1}),
             rec("intersect.union_block", 500, 600,
                 {"union_steps": 5, "union_blocks": 1}),
             rec("intersect.union_block", 50_000, 60_000,
                 {"union_steps": 1000})])
    assert reader("union_steps.frame").read(ctx("frame", n=3)) == 12 / 3


def test_readers_without_records(records):
    records([])
    for name, it in (("host_syncs.frame", "frame"),
                     ("host_syncs.step", "step"),
                     ("union_steps.frame", "frame"),
                     ("idle_in_intersect.frame", "frame"),
                     ("idle_in_shade.frame", "frame"),
                     ("recompute_s.step", "step")):
        assert reader(name).read(ctx(it)) is None, name


def test_readers_idle_split(records):
    """Device activity [1000, 2000], [3000, 4000], [4500, 5000],
    [9000, 9500]: gaps of 1000 ns ending at 3000, 500 at 4500, 4000 at
    9000.  At 3000 the innermost span is an intersection inside a round,
    at 4500 a shading chunk, at 9000 only the frame."""
    records([rec("frame", 150, 9800),
             rec("round", 200, 8000, parent=150),
             rec("intersect.closest", 2500, 3500, parent=200),
             rec("shade.emitter", 3600, 7000, parent=200),
             rec("shade.chunk", 4000, 4600, parent=3600)])
    device = [(1000, 2000, "a"), (3000, 4000, "b"), (4500, 5000, "c"),
              (9000, 9500, "d")]
    c = ctx("frame", device=device)
    assert reader("idle_in_intersect.frame").read(c) == pytest.approx(
        1000 / 5500)
    assert reader("idle_in_shade.frame").read(c) == pytest.approx(500 / 5500)
    split = program_spans.idle_split(c)
    assert split == pytest.approx({"intersect": 1000 / 5500,
                                   "shade": 500 / 5500,
                                   "entry": 4000 / 5500})
    assert reader("idle_in_intersect.frame").read(
        dict(c, iteration="step")) is None


def test_idle_split_outside_spans(records):
    records([rec("shade.chunk", 2500, 2600)])
    device = [(1000, 2000, "a"), (3000, 4000, "b")]
    assert program_spans.idle_split(ctx("frame", device=device)) == {
        program_spans.OUTSIDE: 1.0}


def test_reader_recompute_seconds(records):
    """Whole recompute spans, a nested one once: [1000, 3000] ⊃ [1500,
    2000], and [4000, 4500]; the one after the window is left out."""
    records([rec("remat.recompute", 1000, 3000, thread=2),
             rec("remat.recompute", 1500, 2000, parent=1000, thread=2),
             rec("shade.chunk", 3500, 3900),
             rec("remat.recompute", 4000, 4500, thread=2),
             rec("remat.recompute", 20_000, 25_000, thread=2)])
    got = reader("recompute_s.step").read(ctx("step", n=2))
    assert got == pytest.approx(2500e-9 / 2)
    assert reader("recompute_s.step").read(ctx("frame")) is None


def test_threads_keep_their_own_stacks():
    """Threads open spans and count inside and outside them at once: every
    span's parent is its own thread's, and no count is lost."""
    import sys
    import threading
    n_threads, n_iter = 16, 300
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_iter):
                with tracing.span("round", index=i):
                    with tracing.span("intersect.closest"):
                        tracing.count("sync.visit_limit")
                    tracing.count("rounds")
                tracing.count("kernel.philox_uniform")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs) == 2 * n_threads * n_iter
    for r in recs:
        if r.name == "crt.intersect.closest":
            p = by_id[r.parent]
            assert p.name == "crt.round" and p.thread == r.thread
        else:
            assert r.parent is None
    assert tracing.totals() == {"sync.visit_limit": n_threads * n_iter,
                                "rounds": n_threads * n_iter,
                                "kernel.philox_uniform": n_threads * n_iter}

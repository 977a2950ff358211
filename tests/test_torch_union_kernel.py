"""Kernel 4, the shared-origin shadow sweep's visit loop, modelled in numpy.

``csrc/union_sweep.cu`` runs on the card only.  ``kernel_model`` runs its
loop nest here: for each pixel, each live visit slot, the cluster's
S-independent terms once per triangle, then each of the kernel's triangle
groups testing its triangles against every sample, the per-slot counts
summed in int32 and narrowed to int16 once at the end.  Every case holds
the model, ``union_sweep.union_visits_reference`` and
``traverse.any_hit_tint_shared`` (the plain loop on CPU tensors) to each
other, bit for bit, on random triangle soups: opaque and transparent
lanes, dead padding lanes, gaps in ``ok``, samples whose excluded
primitive is hit, and both the 13- and 17-field packs.  The wrapper's
CPU route, its refusals and its C entry's argument count are checked
too.
"""

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.accel import traverse as TT
from c_raytracer_tpu_torch.accel import union_sweep as US
from c_raytracer_tpu_torch.core import tracing

pytest_plugins = ("torch_harness",)

F32 = np.float32
THREADS = 256      # csrc/union_sweep.cu kThreads


def soup(seed, transparent, n_slots=2, M=150, C=16, n_dead=9, gid0=3):
    """A ClusterSet of M random triangles near the unit cube (the last
    ``n_dead`` packed as dead lanes, the pack padded to whole clusters),
    half of them transparent over ``n_slots`` slots when ``transparent``."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (M, 3)).astype(F32)
    e1 = rng.uniform(-0.6, 0.6, (M, 3)).astype(F32)
    e2 = rng.uniform(-0.6, 0.6, (M, 3)).astype(F32)
    n = np.cross(e1, e2).astype(F32)
    eps = np.full(M, 1e-6, F32)
    valid = np.arange(M) < M - n_dead
    kt = transp = None
    if transparent:
        kt = torch.tensor(rng.uniform(0.2, 0.9, (M, 3)).astype(F32))
        transp = torch.tensor(rng.random(M) < 0.5)
    blk, lo, hi, flat, bound = TT._pack_from_arrays(
        *(torch.tensor(x) for x in (v0, e1, e2, n, eps, valid)), kt, transp,
        C)
    slot = None
    if transparent:
        K = blk.shape[0]
        slot_np = np.full(K * C, -1, np.int64)
        t = transp.numpy() & valid
        slot_np[:M][t] = rng.integers(0, n_slots, int(t.sum()))
        slot = torch.tensor(slot_np)
    return TT.ClusterSet(blk=blk, lo=lo, hi=hi, gid0=gid0, flat=flat,
                         bound=bound, slot=slot,
                         n_slots=n_slots if transparent else 0)


def queries(cs, seed, P=5, S=37, V=12, n_steps=10):
    """(origin, cids, ok, d, md, ex): P origins, each with V random
    clusters (ok with gaps, the rest of each row free), S samples aimed
    at random points of those clusters' triangles, segment ends before
    and beyond them, and some samples excluding the triangle they aim
    at."""
    rng = np.random.default_rng(seed)
    K, _, C = cs.blk.shape
    blk = cs.blk.numpy()
    origin = rng.uniform(-2.5, 2.5, (P, 3)).astype(F32)
    cids = rng.integers(0, K, (P, V))
    ok = rng.random((P, V)) < 0.8
    ok[:, n_steps + 1:] = rng.random((P, V - n_steps - 1)) < 0.5
    d = np.empty((P, S, 3), F32)
    md = np.empty((P, S), F32)
    ex = np.full((P, S), -1, np.int64)
    for p in range(P):
        for s in range(S):
            cid = cids[p, rng.integers(0, n_steps)]
            lane = rng.integers(0, C)
            b = rng.dirichlet([1.0, 1.0, 1.0])
            pt = (blk[cid, 0:3, lane] + b[1] * blk[cid, 3:6, lane]
                  + b[2] * blk[cid, 6:9, lane])
            seg = pt - origin[p]
            dist = F32(np.linalg.norm(seg))
            d[p, s] = seg / max(dist, F32(1e-6))
            md[p, s] = dist * F32(rng.uniform(0.5, 1.6))
            if rng.random() < 0.15:
                ex[p, s] = cs.gid0 + cid * C + lane
    return (torch.tensor(origin), torch.tensor(cids), torch.tensor(ok),
            torch.tensor(d), torch.tensor(md), torch.tensor(ex))


def accumulators(cs, P, S, seed, near_max=False):
    """Random starting ``blocked`` and counts (counts near the int16 limit
    with ``near_max``, so that the narrowing wraps)."""
    rng = np.random.default_rng(seed)
    blocked = torch.tensor(rng.random((P, S)) < 0.1)
    if not cs.has_transp:
        return blocked
    lo = 32764 if near_max else 0
    counts = torch.tensor(rng.integers(lo, lo + 4, (P, S, cs.n_slots))
                          .astype(np.int16))
    return blocked, counts


def kernel_model(cs, origin, cids, ok, n_steps, d, md, ex, acc):
    """Kernel 4's loop nest in numpy float32: pixel, live visit slot, the
    S-independent terms per triangle, then each triangle group g (the
    kernel's 256 threads cover NS samples times 256 / NS groups) testing
    triangles g, g + G, ... against the samples of a pass; int32 sums per
    group and slot, added to the inputs and narrowed once."""
    blk, slot = cs.blk.numpy(), (None if cs.slot is None else cs.slot.numpy())
    o, cid_np, ok_np = origin.numpy(), cids.numpy(), ok.numpy()
    d_np, md_np, ex_np = d.numpy(), md.numpy(), ex.numpy()
    blocked_in, counts_in = acc if cs.has_transp else (acc, None)
    P, S = md_np.shape
    C = blk.shape[2]
    n_slots = cs.n_slots if cs.has_transp else 0
    NS = 32
    while NS < S and NS < THREADS:
        NS *= 2
    G = THREADS // NS
    blocked_out = blocked_in.numpy().copy()
    counts_out = None if counts_in is None else counts_in.numpy().copy()
    for p in range(P):
        for s0 in range(0, S, NS):
            ss = slice(s0, min(S, s0 + NS))
            dx, dy, dz = (d_np[p, ss, i] for i in range(3))
            mdist, exg = md_np[p, ss], ex_np[p, ss]
            n = dx.shape[0]
            g_blocked = np.zeros((G, n), bool)
            g_counts = np.zeros((G, max(1, n_slots), n), np.int32)
            for v in range(n_steps):
                if not ok_np[p, v]:
                    continue
                cid = int(cid_np[p, v])
                r = blk[cid]
                for c in range(C):
                    g = c % G
                    v0x, v0y, v0z = r[0, c], r[1, c], r[2, c]
                    e1x, e1y, e1z = r[3, c], r[4, c], r[5, c]
                    e2x, e2y, e2z = r[6, c], r[7, c], r[8, c]
                    eps = r[12, c]
                    sx, sy, sz = o[p, 0] - v0x, o[p, 1] - v0y, o[p, 2] - v0z
                    qx = sy * e1z - sz * e1y
                    qy = sz * e1x - sx * e1z
                    qz = sx * e1y - sy * e1x
                    tnum = e2x * qx + e2y * qy + e2z * qz
                    hx = dy * e2z - dz * e2y
                    hy = dz * e2x - dx * e2z
                    hz = dx * e2y - dy * e2x
                    a = e1x * hx + e1y * hy + e1z * hz
                    parallel = (a < eps) & (a > -eps)
                    f = F32(1) / np.where(parallel, F32(1), a)
                    u = f * (sx * hx + sy * hy + sz * hz)
                    w = f * (dx * qx + dy * qy + dz * qz)
                    t = f * tnum
                    hit = (~parallel & (u >= 0) & (u <= 1) & (w >= 0)
                           & (u + w <= 1) & (t > eps))
                    gid = cs.gid0 + cid * C + c
                    in_range = hit & (t < mdist) & (exg != gid)
                    if cs.has_transp and r[16, c] > 0:
                        m = slot[cid * C + c]
                        if 0 <= m < n_slots:
                            g_counts[g, m] += in_range
                    else:
                        g_blocked[g] |= in_range
            blocked_out[p, ss] |= g_blocked.any(0)
            if counts_out is not None:
                tot = counts_out[p, ss].astype(np.int32) + g_counts.sum(0).T
                counts_out[p, ss] = tot.astype(np.int16)
    if counts_out is None:
        return torch.tensor(blocked_out)
    return torch.tensor(blocked_out), torch.tensor(counts_out)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    else:
        assert want.dtype == got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want.numpy())


CASES = {
    "opaque": dict(transparent=False, S=37),
    "opaque_S8": dict(transparent=False, S=8),
    "kt_1_slot": dict(transparent=True, n_slots=1, S=37),
    "kt_3_slots_S300": dict(transparent=True, n_slots=3, S=300),
    "kt_near_int16_max": dict(transparent=True, n_slots=2, S=20,
                              near_max=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_the_plain_loop(case):
    kw = dict(CASES[case])
    near_max = kw.pop("near_max", False)
    S = kw.pop("S")
    cs = soup(7, **kw)
    assert cs.blk.shape[1] == (17 if kw["transparent"] else 13)
    n_steps = 10
    origin, cids, ok, d, md, ex = queries(cs, 11, S=S, n_steps=n_steps)
    acc = accumulators(cs, origin.shape[0], S, 5, near_max)
    want = US.union_visits_reference(cs, origin, cids, ok, n_steps, d, md,
                                     ex, acc)
    assert_same(kernel_model(cs, origin, cids, ok, n_steps, d, md, ex, acc),
                want)
    assert_same(US.union_visits(cs, origin, cids, ok, n_steps, d, md, ex,
                                acc), want)
    # the cases reach every branch of the fold
    blocked = want[0] if cs.has_transp else want
    start = acc[0] if cs.has_transp else acc
    assert (blocked & ~start).any() and not blocked.all()
    if cs.has_transp:
        grew = (want[1].int() - acc[1].int()) % 65536
        assert (grew > 0).any()
        if near_max:
            assert (want[1] < 0).any()       # wrapped past 32767
    # the exclusion matters: without it more lanes are in range
    free = US.union_visits_reference(cs, origin, cids, ok, n_steps, d, md,
                                     torch.full_like(ex, -1), acc)
    fb = free[0] if cs.has_transp else free
    assert (fb & ~blocked).any() or (
        cs.has_transp and (free[1] != want[1]).any())


@pytest.mark.parametrize("transparent", [False, True])
def test_shared_sweep_is_the_visit_loop_per_chunk(transparent):
    """``any_hit_tint_shared`` over two sample chunks (the "shared" mode's
    layout, (P, nchunks, lc)) with dead_skip: each chunk is one call of the
    visit loop up to the longest live list, equal to the model's."""
    cs = soup(3, transparent, n_slots=2)
    P, nc, lc = 4, 2, 9
    origin, cids, ok, d, md, ex = queries(cs, 4, P=P, S=nc * lc, V=12,
                                          n_steps=11)
    ok[:, 11:] = False                     # the longest live list is 11
    acc = accumulators(cs, P, nc * lc, 6)
    acc3 = (tuple(a.reshape((P, nc, lc) + a.shape[2:]) for a in acc)
            if transparent else acc.reshape(P, nc, lc))

    def dirs_fn(ci):
        sl = slice(ci * lc, (ci + 1) * lc)
        return d[:, sl], md[:, sl], ex[:, sl]

    tracing.reset()
    tracing.enable()
    try:
        got = TT.any_hit_tint_shared(cs, origin, cids, ok, dirs_fn, nc, acc3,
                                     dead_skip=True, steps="union_steps")
        counts = tracing.totals()
    finally:
        tracing.disable()
        tracing.reset()
    assert counts.get("union_steps") == 11
    assert counts.get("sync.visit_limit") == 1
    assert "kernel.union_sweep" not in counts      # the CPU's plain loop
    want = kernel_model(cs, origin, cids, ok, 11, d, md, ex, acc)
    if transparent:
        got = tuple(a.reshape((P, nc * lc) + a.shape[3:]) for a in got)
    else:
        got = got.reshape(P, nc * lc)
    assert_same(got, want)


def test_cpu_tensors_take_the_plain_loop(monkeypatch):
    """On CPU tensors the wrapper neither builds nor launches anything."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_native, "lib", no_lib)
    cs = soup(1, True, n_slots=2)
    origin, cids, ok, d, md, ex = queries(cs, 2)
    acc = accumulators(cs, 5, 37, 3)
    assert_same(US.union_visits(cs, origin, cids, ok, 10, d, md, ex, acc),
                US.union_visits_reference(cs, origin, cids, ok, 10, d, md,
                                          ex, acc))


def _inputs(transparent=True, n_slots=2):
    cs = soup(2, transparent, n_slots=n_slots)
    origin, cids, ok, d, md, ex = queries(cs, 9)
    return cs, [origin, cids, ok, 10, d, md, ex,
                accumulators(cs, 5, 37, 1)]


def test_check_inputs_takes_a_well_formed_call():
    for transparent in (False, True):
        cs, args = _inputs(transparent)
        US.check_inputs(cs, *args)


@pytest.mark.parametrize("fault", ["md_float64", "cids_int32", "ok_uint8",
                                   "d_not_contiguous", "counts_int32",
                                   "blocked_shape", "n_steps_above_V",
                                   "too_many_slots"])
def test_check_inputs_refuses(fault):
    cs, args = _inputs(n_slots=US.MAX_SLOTS + 1 if fault == "too_many_slots"
                       else 2)
    origin, cids, ok, n_steps, d, md, ex, (blocked, counts) = args
    if fault == "md_float64":
        md = md.double()
    elif fault == "cids_int32":
        cids = cids.int()
    elif fault == "ok_uint8":
        ok = ok.to(torch.uint8)
    elif fault == "d_not_contiguous":
        d = d.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "counts_int32":
        counts = counts.int()
    elif fault == "blocked_shape":
        blocked = blocked[:, :-1]
    elif fault == "n_steps_above_V":
        n_steps = cids.shape[1] + 1
    with pytest.raises(ValueError, match="union_visits"):
        US.check_inputs(cs, origin, cids, ok, n_steps, d, md, ex,
                        (blocked, counts))


@pytest.mark.parametrize("transparent", [False, True])
def test_kernel_args_match_the_c_signature(transparent):
    """``crt_union_sweep`` is bound with one ctypes type per argument the
    wrapper passes: a pointer (an int, or None for an absent table) where
    the signature says c_void_p, an int32 where it says c_int."""
    src, argtypes = _native._SIGNATURES["crt_union_sweep"]
    assert src == "union_sweep.cu" and src in _native.sources()
    cs, args = _inputs(transparent)
    acc = args[-1]
    out = (tuple(torch.empty_like(a) for a in acc) if transparent
           else torch.empty_like(acc))
    got = US.kernel_args(cs, *args, out, 0)
    assert len(got) == len(argtypes)
    for i, (a, ty) in enumerate(zip(got, argtypes)):
        if ty is _native._PTR:
            assert a is None or (isinstance(a, int) and a > 0) or (
                i == len(got) - 1 and a == 0), (i, a)
        else:
            assert ty is _native._INT and isinstance(a, int)
            assert -2 ** 31 <= a < 2 ** 31, (i, a)
    nulls = [i for i, a in enumerate(got) if a is None]
    assert nulls == ([] if transparent else [7, 9, 11])
    P, S = args[5].shape
    K, F, C = cs.blk.shape
    assert got[12:20] == (P, args[1].shape[1], 10, S, F, C, cs.gid0,
                          cs.n_slots)

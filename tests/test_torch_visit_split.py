"""Kernel 3's split of the boxes and its merge, modelled in numpy.

``csrc/visit_order.cu`` runs on the card only.  Its per-box arithmetic is
that of ``visit_order_reference`` (held against JAX in
``test_torch_accel.py``); what the kernel adds is the split of the K boxes
into id-contiguous warp slices (``pallas_visit.visit_split``), a sorted
VM-list and an overlap count per slice, and a merge of those lists by
(key, id): first over the warps of a block, then over the blocks of a
cluster, each entry placed at its index plus the number of smaller entries
in the other lists.  ``kernel_model`` does the same in numpy, and every
case holds it to ``visit_order_reference``: exact equality of the ok mask,
the spill, and the cids and entries on ok slots.
"""

from bisect import bisect_left

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.accel import pallas_visit as PV

pytest_plugins = ("torch_harness",)

F32 = np.float32
FLT_MAX = F32(PV.FLT_MAX)


def slab(o, d, lo, hi):
    """(entry (R, K), overlap (R, K), live (R,)) as the kernel computes
    them: IEEE min/max that drop NaNs, and rays with a NaN rejected."""
    dd = np.where(np.abs(d) < F32(1e-30), F32(1e-30), d).astype(F32)
    inv = (F32(1) / dd).astype(F32)
    tmin = tmax = None
    for c in range(3):
        t1 = (lo[None, :, c] - o[:, c, None]) * inv[:, c, None]
        t2 = (hi[None, :, c] - o[:, c, None]) * inv[:, c, None]
        a, b = np.fmin(t1, t2), np.fmax(t1, t2)
        tmin = a if tmin is None else np.fmax(tmin, a)
        tmax = b if tmax is None else np.fmin(tmax, b)
    entry = np.fmax(tmin, F32(0))
    live = ~(np.isnan(o).any(1) | np.isnan(d).any(1))
    return entry, (tmax >= entry) & live[:, None], live


def merge(lists, cap):
    """The kernel's merge of (key, id)-sorted lists: each entry goes to
    its index plus the entries below it in every other list; places from
    ``cap`` on are dropped.  The places filled must be exactly 0..n-1."""
    out = [None] * cap
    for a, mine in enumerate(lists):
        for j, e in enumerate(mine):
            pos = j + sum(bisect_left(other, e)
                          for b, other in enumerate(lists) if b != a)
            if pos < cap:
                assert out[pos] is None
                out[pos] = e
    n = min(cap, sum(len(x) for x in lists))
    assert all(e is not None for e in out[:n])
    assert all(e is None for e in out[n:])
    return out[:n]


def kernel_model(o, d, lo, hi, V, count_max_dist=None, n_sm=PV.N_SM_H100,
                 after=None, spill_v=None):
    """(cids, entry, spill) as kernel 3 builds them under the wrapper's
    split for a card of ``n_sm`` SMs: per slice the first VM overlaps of
    its stable sort (the register or shared-memory list) and its count;
    merge 1 over each block's warps to VM, merge 2 over the cluster's
    blocks to V.  A later pass of a call above 256 slots admits only boxes
    after each ray's ``after[r]`` = (key, id) and counts its spill against
    the call's ``spill_v`` slots."""
    R, K = o.shape[0], lo.shape[0]
    split = PV.visit_split(R, K, V, n_sm)
    slices = split.slices(K)
    entry, overlap, live = slab(o, d, lo, hi)
    counted = overlap if count_max_dist is None else (
        overlap & (entry < count_max_dist[:, None]))
    cids = np.zeros((R, V), np.int32)
    ent = np.full((R, V), FLT_MAX, F32)
    spill = np.zeros(R, np.int32)
    for r in range(R):
        lists, count = [], 0
        for a, b in slices:
            ids = [i for i in range(a, b) if overlap[r, i]
                   and entry[r, i] < FLT_MAX
                   and (after is None or (entry[r, i], i) > after[r])]
            ids.sort(key=lambda i: entry[r, i])             # stable
            lists.append([(float(entry[r, i]), i) for i in ids[:split.vm]])
            count += int(counted[r, a:b].sum())
        w = split.warps
        blocks = [merge(lists[q * w:(q + 1) * w], split.vm)
                  for q in range(split.cluster)]
        for j, (k, i) in enumerate(merge(blocks, V)):
            cids[r, j], ent[r, j] = i, k
        spill[r] = max(count - (V if spill_v is None else spill_v), 0)
    return cids, ent, spill


def boxes(seed, K, half=(0.3, 1.5)):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (K, 3)).astype(F32)
    h = rng.uniform(*half, (K, 3)).astype(F32)
    return (c - h).astype(F32), (c + h).astype(F32)


def rays(seed, R, lo, hi):
    """Origins in [-5, 5)^3; half the rays aimed at a box centre, so most
    rays enter several boxes, half in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (R, 3)).astype(F32)
    d = rng.normal(size=(R, 3)).astype(F32)
    aim = (0.5 * (lo + hi))[rng.integers(0, lo.shape[0], R)] - o
    d[::2] = aim[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[3] = [0.0, 1.0, 0.0]                      # axis-parallel: |d| < 1e-30
    return o, d.astype(F32)


def duplicate_at_boundaries(lo, hi, R, V, n_sm=PV.N_SM_H100):
    """Copies of box 0 on both sides of every slice boundary of the
    (R, K, V) split, which block boundaries are too, and boxes holding
    every origin (entry 0 for every ray) around the first ones."""
    lo, hi = lo.copy(), hi.copy()
    split = PV.visit_split(R, lo.shape[0], V, n_sm)
    ends = [b for _, b in split.slices(lo.shape[0])[:-1]]
    for b in ends:
        if 2 <= b <= lo.shape[0] - 2:
            lo[[b - 2, b + 1]], hi[[b - 2, b + 1]] = lo[0], hi[0]
    for b in ends[:2]:
        if 1 <= b <= lo.shape[0] - 1:
            lo[b - 1:b + 1], hi[b - 1:b + 1] = F32(-100), F32(100)
    return lo, hi


def case(name):
    """(o, d, lo, hi, V, count_max_dist) of one named case."""
    lo, hi = boxes(1, 200)
    o, d = rays(2, 64, lo, hi)
    cmd = None
    if name == "random":
        V = 16
    elif name == "ties":
        lo, hi = duplicate_at_boundaries(lo, hi, 64, 8)
        V = 8
    elif name == "count_max_dist":
        V = 4
        cmd = np.random.default_rng(3).uniform(0.5, 6, 64).astype(F32)
    elif name == "V1":
        V = 1
    elif name == "V64":
        V = 64
    elif name == "V=K":
        lo, hi = lo[:40], hi[:40]
        o, d = rays(4, 64, lo, hi)
        V = 40
    elif name == "K<slices":
        lo, hi = lo[:5], hi[:5]
        o, d = rays(5, 64, lo, hi)
        V = 3
    elif name == "R45":
        o, d = o[:45], d[:45]
        V = 16
    elif name == "nan":
        o, d = o.copy(), d.copy()
        o[1, 0] = np.nan
        d[7, 2] = np.nan
        V = 16
    elif name in ("V128", "V256", "ties_V256", "count_max_dist_V104"):
        # the shared-memory lists: 1,200 large boxes, so that a ray
        # overlaps more boxes than a warp's slice keeps
        lo, hi = boxes(6, 1200, half=(1.5, 3.0))
        o, d = rays(7, 64, lo, hi)
        V = {"V128": 128, "count_max_dist_V104": 104}.get(name, 256)
        if name == "ties_V256":
            lo, hi = duplicate_at_boundaries(lo, hi, 64, V, N_SM[name])
        if name == "count_max_dist_V104":
            cmd = np.random.default_rng(8).uniform(0.5, 6, 64).astype(F32)
    return o, d, lo, hi, V, cmd


CASES = ["random", "ties", "count_max_dist", "V1", "V64", "V=K",
         "K<slices", "R45", "nan", "V128", "V256", "ties_V256",
         "count_max_dist_V104"]
# the shared-memory cases split as on a card of 2 SMs: one block a ray
# group, whose warps' slices are long enough to overflow their lists
N_SM = {"V128": 2, "V256": 2, "ties_V256": 2, "count_max_dist_V104": 2}


@pytest.mark.parametrize("name", CASES)
def test_kernel_model_equals_reference(name):
    """The numpy model of the kernel's split and merge against the plain
    version: exact equality (ok mask, spill, cids and entries on ok)."""
    o, d, lo, hi, V, cmd = case(name)
    n_sm = N_SM.get(name, PV.N_SM_H100)
    mc, me, ms = kernel_model(o, d, lo, hi, V, cmd, n_sm)
    t = torch.from_numpy
    pc, pe, ps = PV.visit_order_reference(
        t(o), t(d), t(lo), t(hi), V, None if cmd is None else t(cmd))
    pc, pe, ps = pc.numpy(), pe.numpy(), ps.numpy()
    ok = pe < FLT_MAX
    np.testing.assert_array_equal(me < FLT_MAX, ok)
    np.testing.assert_array_equal(ms, ps)
    np.testing.assert_array_equal(mc[ok], pc[ok])
    np.testing.assert_array_equal(me[ok], pe[ok])
    assert ok.sum() > 0
    if name in ("random", "count_max_dist", "ties", "V1", "V128", "V256",
                "ties_V256", "count_max_dist_V104"):
        assert ps.max() > 0               # the lists were truncated
    if name in ("V128", "V256", "ties_V256"):
        # some warp slice held more overlaps than its list keeps
        split = PV.visit_split(o.shape[0], lo.shape[0], V, n_sm)
        _, overlap, _ = slab(o, d, lo, hi)
        assert max(overlap[:, a:b].sum(1).max()
                   for a, b in split.slices(lo.shape[0])) > split.vm
    if name in ("ties", "ties_V256"):     # the entry-0 boxes lead, id order
        assert (pe[:, :4] == 0).all() and (np.diff(pc[:, :4]) > 0).all()
    if name == "nan":
        assert not ok[1].any() and not ok[7].any() and ps[1] == ps[7] == 0


@pytest.mark.parametrize("R,K,V", [
    (2048, 8556, 16), (2048, 8556, 64), (300, 8556, 16), (4096, 8556, 64),
    (2048, 8553, 16), (2048, 1001, 8), (2048, 5, 5), (45, 200, 16),
    (65536, 8556, 16), (1, 1, 1), (2048, 8556, 32), (2048, 8556, 1),
    (2048, 6300, 64), (2048, 6300, 104), (2048, 6300, 128),
    (2048, 6300, 256), (300, 1001, 200)])
def test_split_covers_boxes_and_fits_the_card(R, K, V):
    """Slices cover [0, K) once, in id order, each starting at a multiple
    of 4 boxes (16-byte aligned copies); the grid holds every ray and fits
    an H100: cluster <= 8 blocks, 2 to 8 warps a block (8 up to VM = 32, 4
    at 64, whose register lists take twice the registers, and at 128; 2 at
    256, whose shared-memory lists take 64 KB a warp).  The block's dynamic
    shared memory is the kernel's own layout; ``csrc/visit_order.cu`` holds
    it to 227 KB for every list size at its most warps with a
    static_assert."""
    split = PV.visit_split(R, K, V)
    covered = [i for a, b in split.slices(K) for i in range(a, b)]
    assert covered == list(range(K))
    assert all(a % 4 == 0 for a, b in split.slices(K) if b > a)
    assert split.slice % 4 == 0
    assert split.vm >= V and split.vm in PV.LIST_SIZES
    assert split.groups * PV.LANES >= R > (split.groups - 1) * PV.LANES
    assert 1 <= split.cluster <= PV.MAX_CLUSTER
    assert split.warps == {8: 8, 16: 8, 32: 8, 64: 4, 128: 4,
                           256: 2}[split.vm]
    if R == 2048:                        # a block on every SM of the card
        assert split.groups * split.cluster >= PV.N_SM_H100


def test_split_refuses_what_the_kernel_does_not_take():
    """V outside 1..K: the card refuses it and names the limit; any V up
    to K is taken, above 256 in passes of 256."""
    with pytest.raises(ValueError, match="V=8557 outside 1..K=8556"):
        PV.visit_split(2048, 8556, 8557)
    with pytest.raises(ValueError, match="V=0"):
        PV.visit_split(2048, 8556, 0)
    split = PV.visit_split(2048, 8556, 8556)
    assert split.vm == 256 and split.passes == 34 == len(
        PV.visit_passes(8556))

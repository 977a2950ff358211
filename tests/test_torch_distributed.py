"""The port's mesh over ranks of a ``torch.distributed`` process group:
gloo ranks on the CPU, started by ``parallel/launch.py``.

* 2 ranks: pixel tiles over ``px`` (the lit soup of tests/test_parallel.py
  at 16x16 in 4 tiles of 64 pixels, transparent, per-shard cluster sweeps
  and union shadows), the frame, z and stats bit-equal to the
  one-process ``make_renderer`` frame on every rank; a train step whose
  loss equals the one-process loss and whose grads are within
  1e-6·max|g| of the one-process step's (the all-reduce regroups the
  sums); and two ``sp`` replicas of path GI spp 4, equal to the mean of
  the two replica frames rendered in one process; and a train step over
  ``pr`` = 2 whose grads are bit for bit those of one process with the 2
  triangle ranges stacked;
* 4 ranks on a (px 2, sp 1, pr 2) mesh: each pr rank holds one triangle
  range; the frame bit-equal to the one-process frame and to 2 stacked
  ranges, the train step's grads (tri_vertices through the gathered
  fold) within 1e-6·max|g|;
* the dry run (``entry.dryrun_multichip``) on 2 CPU ranks;
* no fallback: NCCL without a card a rank, and NCCL on CPU ranks, raise
  before any rank starts.

``camera.focal_length``, whose exact gradient is 0, is held at the scale
of ``camera.position`` (as in tests/test_torch_grad.py).  Each rank runs
``torch.set_num_threads(1)`` (``launch(threads=1)``): ranks that each spin
on every core while gloo waits run many times slower.  This module
imports no JAX: the ranks import it to find their functions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.entry import dryrun_multichip
from c_raytracer_tpu_torch.parallel import (launch, make_mesh,
                                            make_sharded_renderer,
                                            make_train_step)
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import make_scene
from c_raytracer_tpu_torch.scene.convert import named_leaves

RES = 16
THREADS = 1
CFG = RenderConfig(max_bounces=2, rounds=4, light_chunk=4, accel="cluster",
                   bvh_visits=64, bvh_shadow_visits=64, tile_size=64)
GI_CFG = RenderConfig(max_bounces=1, gi_model="path", samples_per_pixel=4,
                      light_chunk=4, accel="none")
GRAD_RTOL = 1e-6
SCALE_OF = {"camera.focal_length": "camera.position"}


def lit_kwargs(nt=600, transparent=True, seed=0):
    """make_scene arguments of ``_lit_soup`` (tests/test_parallel.py): a
    triangle soup with an emitting sphere and ambient light."""
    rng = np.random.default_rng(seed)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)
    tri_mat = dict(ks=[1, 1, 1], ka=[.2, .2, .2], tex_color=[1, 1, 1])
    if transparent:
        tri_mat["kt"] = [.5, .6, .7]
    return dict(
        sphere_center=[[0.0, 0.0, 0.0], [0.0, 6.0, -2.0]],
        sphere_radius=[0.5, 1.0],
        sphere_material=[0, 2], sphere_lights=[0, 4],
        tri_vertices=tv, tri_material=[1] * nt,
        plane_point=[[0, -4, 0]], plane_normal=[[0, 1, 0]],
        plane_material=[0],
        materials=[
            dict(ks=[1, 1, 1], ka=[.1, .1, .1], tex_color=[1, 1, 1]),
            tri_mat,
            dict(ke=[4, 4, 4], tex_color=[1, 1, 1]),
        ],
        camera=dict(position=[0, 0, -8], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=60, focal_length=1),
        ambient=(0.3, 0.3, 0.3))


def soup(nt=600):
    return reorder_scene(make_scene(**lit_kwargs(nt=nt)))


def target():
    return torch.full((RES, RES, 3), 0.01)


def _frame_and_step(sc, cfg, mesh, device):
    img, z, st = make_sharded_renderer(sc.static, cfg, RES, RES, mesh,
                                       device=device, with_stats=True)(
        sc.params, PhiloxSampler(3, device))
    loss, grads = _step(sc, cfg, mesh, device)
    return dict(coord=mesh.coord, img=img, z=z,
                stats={k: float(v) for k, v in st.items()}, loss=loss,
                grads=grads)


def _step(sc, cfg, mesh, device, shards=None):
    _, loss, grads = make_train_step(sc.static, cfg, RES, RES, mesh,
                                     device=device, with_grads=True,
                                     shards=shards)(
        sc.params, PhiloxSampler(3, device), target())
    return float(loss), dict(named_leaves(grads))


def _two_ranks(rank, device):
    """px = 2: a frame and a train step; sp = 2: a GI frame; pr = 2: a
    train step."""
    px = _frame_and_step(soup(), CFG, make_mesh(2), device)
    mesh = make_mesh(1, 2)
    img, z, st = make_sharded_renderer(soup(64).static, GI_CFG, RES, RES,
                                       mesh, device=device,
                                       with_stats=True)(
        soup(64).params, PhiloxSampler(5, device))
    return px, dict(coord=mesh.coord, img=img, z=z,
                    stats={k: float(v) for k, v in st.items()}), \
        _step(soup(), CFG, make_mesh(1, 1, 2), device)


def _four_ranks(rank, device):
    """(px 2, sp 1, pr 2): a frame and a train step."""
    return _frame_and_step(soup(), CFG, make_mesh(2, 1, 2), device)


@pytest.fixture(scope="module")
def one_process():
    """The one-process frame and train step of ``CFG``."""
    sc = soup()
    return _frame_and_step(sc, CFG, make_mesh(), "cpu")


def check_grads(got, want):
    for k, g in want.items():
        scale = float(want[SCALE_OF.get(k, k)].abs().max()) \
            if g.numel() else 0.0
        err = float((got[k] - g).abs().max()) if g.numel() else 0.0
        assert err <= GRAD_RTOL * scale, \
            f"{k}: {err:.3e} > {GRAD_RTOL} x {scale:.3e}"


def check_frame(got, want):
    assert torch.equal(got["img"], want["img"])
    assert torch.equal(got["z"], want["z"])
    assert got["stats"] == want["stats"]


def test_px_and_sp_ranks(one_process):
    res = launch(_two_ranks, 2, backend="gloo", device="cpu",
                 threads=THREADS)
    assert [r[0]["coord"] for r in res] == [(0, 0, 0), (1, 0, 0)]
    assert [r[1]["coord"] for r in res] == [(0, 0, 0), (0, 1, 0)]
    assert float(one_process["img"].max()) > 1e-3
    for px, _, _ in res:
        check_frame(px, one_process)
        assert px["loss"] == one_process["loss"]
        check_grads(px["grads"], one_process["grads"])

    # sp: each replica renders spp 2 from sampler.fold_in(s)
    sc = soup(64)
    local = dataclasses.replace(GI_CFG, samples_per_pixel=2)
    reps = [make_renderer(sc.static, local, RES, RES, device="cpu",
                          with_stats=True)(sc.params,
                                           PhiloxSampler(5, "cpu").fold_in(s))
            for s in range(2)]
    want = dict(img=(reps[0][0] + reps[1][0]) / 2, z=reps[0][1],
                stats={k: float(reps[0][2][k] + reps[1][2][k])
                       for k in reps[0][2]})
    assert float(want["img"].max()) > 0
    assert not torch.equal(reps[0][0], reps[1][0])
    for _, sp, _ in res:
        check_frame(sp, want)

    # pr = 2: the ranges' sweeps run without autograd and the winner is
    # formed again from the replicated tables, so each rank's graph is the
    # one process's with the 2 ranges stacked, and so are the grads, bit
    # for bit
    loss, grads = _step(soup(), CFG, make_mesh(), "cpu", shards=2)
    for _, _, (r_loss, r_grads) in res:
        assert r_loss == loss
        for k, g in grads.items():
            assert torch.equal(r_grads[k], g), k


def test_px_pr_ranks(one_process):
    res = launch(_four_ranks, 4, backend="gloo", device="cpu",
                 threads=THREADS)
    assert [r["coord"] for r in res] == [(0, 0, 0), (0, 0, 1), (1, 0, 0),
                                         (1, 0, 1)]
    sc = soup()
    stacked = make_renderer(sc.static, CFG, RES, RES, device="cpu",
                            with_stats=True, shards=2)(
        sc.params, PhiloxSampler(3, "cpu"))
    assert torch.equal(stacked[0], one_process["img"])
    assert float(one_process["grads"]["tri_vertices"].abs().max()) > 0
    for r in res:
        check_frame(r, one_process)
        assert r["loss"] == one_process["loss"]
        check_grads(r["grads"], one_process["grads"])


def test_dryrun_on_cpu_ranks(capsys):
    out = dryrun_multichip(2, backend="gloo", device="cpu", threads=THREADS)
    assert [ph["mesh"] for ph in out] == [(1, 2, 1), (1, 1, 2)]
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(" OK") for line in lines) == 2


def test_nccl_without_a_card_a_rank_raises():
    """The launch takes the devices it is asked for and no others."""
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError, match="nccl needs one card a rank"):
        launch(_four_ranks, n, backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="nccl needs one card a rank"):
        dryrun_multichip(n)
    with pytest.raises(ValueError, match="gloo"):
        launch(_four_ranks, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError):
        launch(_four_ranks, 2, backend="mpi", device="cpu")

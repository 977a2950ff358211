"""Primitive intersection for dense sphere/plane scenes, as in
``c_raytracer_tpu.geometry.primitives`` (its SoA hot path).

* ``DeviceScene`` — the scene's tensors on the render device, with the
  per-primitive epsilon and material tables;
* ``closest_hit_soa`` — closest intersection over all primitives with the
  reference's exact accept rules (sphere: object.c:306-321; plane:
  object.c:473-488), folded as a running minimum over the handful of
  primitives (planes first, then spheres; strictly-smaller t wins,
  accel.c:328) with the winner's material carried through the fold.

Triangles (and so meshes) are not ported yet: ``device_scene`` refuses a
scene that has them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.scene import types as T

FLT_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Sphere/plane geometry + per-primitive and material tables on a
    device."""

    # spheres
    sph_center: torch.Tensor   # (Ns, 3)
    sph_radius: torch.Tensor   # (Ns,)
    sph_eps: torch.Tensor      # (Ns,)
    # planes
    pln_n: torch.Tensor        # (Np, 3)
    pln_d: torch.Tensor        # (Np,)
    pln_eps: torch.Tensor      # (Np,)
    # per-material tables
    mat_reflective: torch.Tensor  # (M,) bool, static.is_reflective
    materials: T.Materials
    ambient: torch.Tensor      # (3,)


def device_scene(params: T.SceneParams, static: T.SceneStatic) -> DeviceScene:
    """Scene tensors for rendering.  ``params`` has tensor leaves on the
    render device (scene.convert.params_to_torch)."""
    if static.n_triangles:
        raise NotImplementedError(
            "triangles and meshes are not ported yet (ROADMAP: triangles in "
            "the dense path, then accel/)")
    dev = params.sphere_center.device
    ns = static.n_spheres
    eps = torch.as_tensor(np.asarray(static.epsilon, np.float32), device=dev)
    return DeviceScene(
        sph_center=params.sphere_center, sph_radius=params.sphere_radius,
        sph_eps=eps[:ns],
        pln_n=params.plane_normal, pln_d=params.plane_d, pln_eps=eps[ns:],
        mat_reflective=torch.as_tensor(static.is_reflective, device=dev),
        materials=params.materials,
        ambient=params.ambient,
    )


def _safe_sqrt(x):
    """sqrt(max(x, 0)) with the JAX package's double-where."""
    ok = x > 0
    return torch.where(ok, v3m.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _sphere_test_soa(o: V3, d: V3, c: V3, radius, eps):
    """line_intersects_sphere (object.c:306-321) on component tensors.
    Returns (t, hit): near positive root preferred, else far root; both
    must clear the sphere's epsilon."""
    rel = o - c
    b = -(v3m.dot(d, rel))
    cc = v3m.magsqr(rel) - radius * radius
    det = b * b - cc
    sq = _safe_sqrt(det)
    t_near = b - sq
    t = torch.where(t_near > eps, t_near, b + sq)
    hit = (det >= 0) & (t > eps)
    return t, hit


def _plane_test_soa(o: V3, d: V3, n: V3, dist, eps):
    """plane_get_intersection (object.c:473-488).  Returns (t, hit, a)
    where the sign of ``a = d·n`` decides the normal flip."""
    a = v3m.dot(d, n)
    parallel = torch.abs(a) < eps
    t = (dist - v3m.dot(o, n)) / torch.where(parallel, 1.0, a)
    hit = ~parallel & (t > eps)
    return t, hit, a


def closest_hit_soa(ds: DeviceScene, static, o: V3, d: V3):
    """Closest intersection over all primitives.

    o, d: V3 of (P,).  Returns (t, gid, mat, normal V3); t = FLT_MAX and
    gid = -1 (mat = 0) on a miss."""
    shape, dev = o.x.shape, o.x.device
    bt = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    bg = torch.full(shape, -1, dtype=torch.int64, device=dev)
    bm = torch.zeros(shape, dtype=torch.int64, device=dev)
    bn = v3m.full(shape, 0.0, device=dev)
    ns, npl = static.n_spheres, static.n_planes

    for i in range(npl):
        n = v3m.splat(ds.pln_n[i])
        t, hit, a = _plane_test_soa(o, d, n, ds.pln_d[i], ds.pln_eps[i])
        t = torch.where(hit, t, FLT_MAX)
        better = t < bt
        sgn = torch.where(torch.signbit(a), 1.0, -1.0)  # flip on back side
        bt = torch.where(better, t, bt)
        bg = torch.where(better, ns + i, bg)
        bm = torch.where(better, static.material_index[ns + i], bm)
        bn = v3m.where(better, n * sgn, bn)

    for i in range(ns):
        c = v3m.splat(ds.sph_center[i])
        r = ds.sph_radius[i]
        t, hit = _sphere_test_soa(o, d, c, r, ds.sph_eps[i])
        t = torch.where(hit, t, FLT_MAX)
        better = t < bt
        # outward normal at the hit point (object.c:258-261)
        tn = torch.where(t < FLT_MAX, t, 1.0)
        nrm = (o + d * tn - c) * (1.0 / r)
        bt = torch.where(better, t, bt)
        bg = torch.where(better, i, bg)
        bm = torch.where(better, static.material_index[i], bm)
        bn = v3m.where(better, nrm, bn)

    return bt, bg, bm, bn

"""Scene rescaling — the -r flag (scene.c:109-121, 459-470).

Operates on the host-side Scene bundle: scales primitive parameters, the
per-primitive epsilons, and the camera (position + focal length,
camera.c:35-40).  "norm" normalizes the max bounded-object extent to 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from c_raytracer_tpu_torch.scene import types as T


def bounded_extents(scene: T.Scene) -> tuple[np.ndarray, np.ndarray]:
    """AABB of all bounded objects (object.c:200-225; planes excluded)."""
    mins, maxs = [], []
    p = scene.params
    if scene.static.n_spheres:
        c = np.asarray(p.sphere_center)
        r = np.asarray(p.sphere_radius)[:, None]
        mins.append((c - r).min(0))
        maxs.append((c + r).max(0))
    if scene.static.n_triangles:
        v = np.asarray(p.tri_vertices)
        mins.append(v.min((0, 1)))
        maxs.append(v.max((0, 1)))
    if not mins:
        raise ValueError("no bounded objects")
    return (np.minimum.reduce(mins).astype(np.float32),
            np.maximum.reduce(maxs).astype(np.float32))


def norm_scale_factor(scene: T.Scene) -> float:
    mn, mx = bounded_extents(scene)
    return float(1.0 / np.max(mx - mn))


def scene_scale(scene: T.Scene, factor: float) -> T.Scene:
    """Scale all objects and the camera about the origin (zero shift, like
    scene_scale at scene.c:459-470)."""
    f = np.float32(factor)
    p = scene.params
    st = scene.static

    # plane: move a point on the plane, rescale d (object.c:500-514)
    new_d = p.plane_d * f

    params = dataclasses.replace(
        p,
        sphere_center=p.sphere_center * f,
        sphere_radius=p.sphere_radius * f,
        tri_vertices=p.tri_vertices * f,
        plane_d=new_d,
        camera=dataclasses.replace(
            p.camera,
            position=p.camera.position * f,
            focal_length=p.camera.focal_length * f,
        ),
    )
    static = dataclasses.replace(
        st, epsilon=tuple(float(e * factor) for e in st.epsilon))
    return dataclasses.replace(scene, params=params, static=static)

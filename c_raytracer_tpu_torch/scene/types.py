"""Structure-of-arrays scene representation (host side, NumPy).

The same layout as ``c_raytracer_tpu.scene.types``:

* ``SceneParams`` — the float32 "weights": sphere centers/radii, triangle
  vertices, plane equations, material coefficients, texture parameters and
  the camera.  The loader fills them with host NumPy arrays;
  ``scene.convert.params_to_torch`` gives the same structure with tensor
  leaves on a device.
* ``SceneStatic`` — non-differentiable topology: primitive counts, material
  indices, per-primitive epsilons, emitter tables, texture type ids.

Primitive indexing is global: ``[0, n_spheres)`` spheres,
``[n_spheres, n_spheres+n_triangles)`` triangles, then planes.  Emitters are
global primitive ids (planes cannot be emittant, object.c:452).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# Texture type ids (material.c:152-200)
TEX_UNIFORM = 0
TEX_CHECKERBOARD = 1
TEX_BRICK = 2
TEX_NOISY_PERIODIC = 3

# Periodic function ids (material.h enum PeriodicFunction)
FUNC_SIN = 0
FUNC_SAW = 1
FUNC_TRIANGLE = 2
FUNC_SQUARE = 3

# Primitive type tags
PRIM_SPHERE = 0
PRIM_TRIANGLE = 1
PRIM_PLANE = 2


@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table, array-of-structs -> struct-of-arrays
    (material.h:31-44).  Shapes: (M, 3) for coefficient triples, (M,) else.
    """

    ks: Any
    ka: Any
    kr: Any
    kt: Any
    ke: Any
    shininess: Any
    refractive_index: Any
    # texture parameters, all (M, ...) — unused entries are zero
    tex_color: Any        # uniform color / noisy-periodic base (M, 3)
    tex_color2: Any       # checkerboard/brick second color or gradient (M, 3)
    tex_scale: Any        # checkerboard/brick scale, noise feature scale (M,)
    tex_p1: Any           # brick mortar width / noise scale (M,)
    tex_p2: Any           # noisy-periodic frequency scale (M,)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera (camera.c:19-33): position + two axis vectors (normalized at
    init, NOT re-orthogonalized), fov in degrees, focal length."""

    position: Any   # (3,)
    vector_x: Any   # (3,) normalized
    vector_y: Any   # (3,) normalized
    fov: Any        # () degrees, validated in (0, 180)
    focal_length: Any  # ()


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Scene state (the "weights")."""

    sphere_center: Any    # (Ns, 3)
    sphere_radius: Any    # (Ns,)
    tri_vertices: Any     # (Nt, 3, 3)
    plane_normal: Any     # (Np, 3) normalized
    plane_d: Any          # (Np,)
    materials: Materials
    camera: Camera
    ambient: Any          # (3,) global ambient light (scene.c:104-105)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static (hashable) topology."""

    n_spheres: int
    n_triangles: int
    n_planes: int
    # per-primitive (global index) int/float tuples — hashable
    material_index: tuple          # (N,) index into material arrays
    epsilon: tuple                 # (N,) float per-primitive epsilon
    num_lights: tuple              # (N,) soft-shadow sample count (scene.c:373)
    emitter_prims: tuple           # global prim ids of emittant objects
    # material static info
    tex_type: tuple                # (M,) texture type ids
    tex_func: tuple                # (M,) periodic function ids
    is_reflective: tuple           # (M,) ‖kr‖>1e-6 at load (material.c:81-83)
    is_transparent: tuple          # (M,)
    is_emittant: tuple             # (M,)

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_triangles + self.n_planes

    def prim_type(self, gid: int) -> int:
        if gid < self.n_spheres:
            return PRIM_SPHERE
        if gid < self.n_spheres + self.n_triangles:
            return PRIM_TRIANGLE
        return PRIM_PLANE


@dataclasses.dataclass(frozen=True)
class Scene:
    """Bundle of params + static; what loaders return."""

    params: SceneParams
    static: SceneStatic
    aux: Any = None  # host-side extras


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def make_scene(
    *,
    sphere_center=(), sphere_radius=(), sphere_material=(), sphere_epsilon=(),
    sphere_lights=(),
    tri_vertices=(), tri_material=(), tri_epsilon=(), tri_lights=(),
    plane_point=(), plane_normal=(), plane_material=(), plane_epsilon=(),
    materials: list[dict],
    camera: dict,
    ambient=(0.0, 0.0, 0.0),
) -> Scene:
    """Assemble a Scene from host-side lists (used by the JSON loader and by
    tests constructing scenes programmatically)."""
    ns, nt, npl = len(sphere_radius), len(tri_vertices), len(plane_normal)

    sc = np.asarray(sphere_center, np.float32).reshape(ns, 3)
    sr = np.asarray(sphere_radius, np.float32).reshape(ns)
    tv = np.asarray(tri_vertices, np.float32).reshape(nt, 3, 3)

    pn = np.asarray(plane_normal, np.float32).reshape(npl, 3)
    pp = np.asarray(plane_point, np.float32).reshape(npl, 3)
    # plane_new normalizes the normal and stores d = n·p (object.c:457-466)
    if npl:
        pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
    pd = np.sum(pn * pp, axis=-1) if npl else np.zeros((0,), np.float32)

    mat_index = (tuple(int(i) for i in sphere_material)
                 + tuple(int(i) for i in tri_material)
                 + tuple(int(i) for i in plane_material))

    # auto-epsilon rules (object.c:235-237, 336-339, 453-454), vectorized.
    # Triangle auto-eps uses area = 0.5·|e1×e2|, algebraically identical to
    # the reference's 0.5·|e1||e2|·sin(acos(cos)) but NaN-free when float
    # error pushes |cos| past 1.
    sph_e = (np.asarray(sphere_epsilon, np.float32) if len(sphere_epsilon)
             else np.full(ns, -1.0, np.float32))
    sph_auto = sr * np.float32(0.0003)
    tri_e = (np.asarray(tri_epsilon, np.float32) if len(tri_epsilon)
             else np.full(nt, -1.0, np.float32))
    if nt:
        e0 = tv[:, 1] - tv[:, 0]
        e1v = tv[:, 2] - tv[:, 0]
        area = 0.5 * np.linalg.norm(np.cross(e0, e1v), axis=-1)
        tri_auto = (np.float32(0.003) * area.astype(np.float32) ** 0.75)
    else:
        tri_auto = np.zeros(0, np.float32)
    pln_e = (np.asarray(plane_epsilon, np.float32) if len(plane_epsilon)
             else np.full(npl, -1.0, np.float32))
    eps = np.concatenate([
        np.where(sph_e == -1.0, sph_auto, sph_e),
        np.where(tri_e == -1.0, tri_auto, tri_e),
        np.where(pln_e == -1.0, np.float32(1e-6), pln_e),
    ]).astype(np.float32)

    nl = (tuple(int(x) for x in sphere_lights) if len(sphere_lights)
          else (0,) * ns)
    nl += (tuple(int(x) for x in tri_lights) if len(tri_lights)
           else (0,) * nt)
    nl += (0,) * npl

    m = len(materials)
    def col(key, default=0.0, width=3):
        out = np.full((m, width) if width > 1 else (m,), default, np.float32)
        for i, mt in enumerate(materials):
            if key in mt:
                out[i] = np.asarray(mt[key], np.float32)
        return out

    ks, ka, kr, kt, ke = (col(k) for k in ("ks", "ka", "kr", "kt", "ke"))
    thresh = 1e-6  # MATERIAL_THRESHOLD (material.c:25)
    is_refl = tuple(bool(np.linalg.norm(kr[i]) > thresh) for i in range(m))
    is_trans = tuple(bool(np.linalg.norm(kt[i]) > thresh) for i in range(m))
    is_emit = tuple(bool(np.linalg.norm(ke[i]) > thresh) for i in range(m))

    mats = Materials(
        ks=_f32(ks), ka=_f32(ka), kr=_f32(kr), kt=_f32(kt), ke=_f32(ke),
        shininess=_f32(col("shininess", width=1)),
        refractive_index=_f32(col("refractive_index", 1.0, width=1)),
        tex_color=_f32(col("tex_color")),
        tex_color2=_f32(col("tex_color2")),
        tex_scale=_f32(col("tex_scale", width=1)),
        tex_p1=_f32(col("tex_p1", width=1)),
        tex_p2=_f32(col("tex_p2", width=1)),
    )

    cam_vx = np.asarray(camera["vector_x"], np.float32)
    cam_vy = np.asarray(camera["vector_y"], np.float32)
    fov = float(camera["fov"])
    if not (0.0 < fov < 180.0):
        raise ValueError(
            f"Expected camera fov [{fov:.2f}] between [0.] and [180.].")
    cam = Camera(
        position=_f32(camera["position"]),
        vector_x=_f32(cam_vx / np.linalg.norm(cam_vx)),
        vector_y=_f32(cam_vy / np.linalg.norm(cam_vy)),
        fov=_f32(fov),
        focal_length=_f32(float(camera["focal_length"])),
    )

    params = SceneParams(
        sphere_center=_f32(sc), sphere_radius=_f32(sr),
        tri_vertices=_f32(tv),
        plane_normal=_f32(pn), plane_d=_f32(pd),
        materials=mats, camera=cam, ambient=_f32(ambient),
    )

    # emitters: global prim ids whose material is emittant
    emitters = tuple(
        gid for gid, mi in enumerate(mat_index) if is_emit[mi])

    static = SceneStatic(
        n_spheres=ns, n_triangles=nt, n_planes=npl,
        material_index=mat_index,
        epsilon=tuple(float(e) for e in eps),
        num_lights=nl,
        emitter_prims=emitters,
        tex_type=tuple(int(mt.get("tex_type", TEX_UNIFORM)) for mt in materials),
        tex_func=tuple(int(mt.get("tex_func", FUNC_SIN)) for mt in materials),
        is_reflective=is_refl,
        is_transparent=is_trans,
        is_emittant=is_emit,
    )
    return Scene(params=params, static=static)

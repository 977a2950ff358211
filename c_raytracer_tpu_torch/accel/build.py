"""Host-side acceleration build: Morton ordering of triangles, as in
``c_raytracer_tpu.accel.build`` (its NumPy branch).

The reference builds a binary LBVH over all bounded objects
(accel.c:266-315).  The cluster structure is flatter: triangles are sorted
by the Morton code of their AABB centroid (the reference's code
construction, accel.c:72-88, 290-308) and grouped into fixed-size
contiguous clusters; the device traversal (traverse.py) slab-tests the
cluster AABBs and sweeps the nearest clusters' triangles.  Cluster AABBs
are re-fit on the device from the vertices each frame, so only the
ordering is host state — any ordering is correct, the Morton sort just
makes clusters spatially tight.

The JAX package can also sort with a g++-built helper (its
``accel/native.py``), bit-identical to this NumPy code; the port keeps the
NumPy branch only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from c_raytracer_tpu_torch.scene import types as T


def expand_bits_np(v: np.ndarray) -> np.ndarray:
    """Vectorized expand_bits (accel.c:72-80)."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes_np(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of centroids normalized to their extents
    (accel.c:82-88, 290-308)."""
    c = np.asarray(centroids, np.float32)
    lo = c.min(0)
    span = c.max(0) - lo
    inv = np.where(span > 0, 1.0 / np.where(span > 0, span, 1.0), 0.0)
    n = (c - lo) * inv
    q = np.clip(n * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return ((expand_bits_np(q[:, 0]) << np.uint32(2))
            | (expand_bits_np(q[:, 1]) << np.uint32(1))
            | expand_bits_np(q[:, 2]))


def morton_order(tri_vertices: np.ndarray) -> np.ndarray:
    """Morton-sorted permutation of triangles (stable on equal codes)."""
    tv = np.asarray(tri_vertices, np.float32)
    if tv.shape[0] == 0:
        return np.zeros((0,), np.int64)
    # centroid of the triangle's AABB, like the reference's per-object
    # bounding-cuboid centroid (accel.c:292-299 over get_corners output)
    cen = 0.5 * (tv.min(1) + tv.max(1))
    return np.argsort(morton_codes_np(cen), kind="stable")


def reorder_scene(scene: T.Scene) -> T.Scene:
    """An equivalent Scene with its triangles in Morton order.

    A pure permutation: ``params.tri_vertices`` rows and every
    per-triangle static table are permuted together and emitter ids
    remapped, so rendering is identical up to float summation order."""
    st = scene.static
    nt = st.n_triangles
    if nt <= 1:
        return scene
    ns = st.n_spheres
    perm = morton_order(np.asarray(scene.params.tri_vertices))

    params = dataclasses.replace(
        scene.params, tri_vertices=np.asarray(scene.params.tri_vertices)[perm])

    inv = np.empty(nt, np.int64)     # old triangle index -> new index
    inv[perm] = np.arange(nt)

    def permute_tuple(tup):
        head, tri, tail = tup[:ns], tup[ns:ns + nt], tup[ns + nt:]
        return head + tuple(tri[int(i)] for i in perm) + tail

    def remap_gid(g):
        if ns <= g < ns + nt:
            return ns + int(inv[g - ns])
        return g

    static = dataclasses.replace(
        st,
        material_index=permute_tuple(st.material_index),
        epsilon=permute_tuple(st.epsilon),
        num_lights=permute_tuple(st.num_lights),
        emitter_prims=tuple(sorted(remap_gid(g) for g in st.emitter_prims)),
    )
    return T.Scene(params=params, static=static, aux=scene.aux)

"""Binary STL loading (host side, NumPy-vectorized).

Equivalent of the reference's mesh loader (object.c:521-587): rejects ASCII
files, reads the 80-byte header + uint32 triangle count, then per-triangle
``float normal[3]; float vertices[3][3]; uint16 attrs`` records (normal and
attrs ignored).  Vertices are rotated by an Euler XYZ matrix, scaled and
translated (object.c:550-580).

The reference loops per triangle; here the whole file is one structured-array
read + one einsum — the natural vectorization for 100k-triangle meshes.
"""

from __future__ import annotations

import numpy as np

_STL_DTYPE = np.dtype([
    ("normal", "<f4", (3,)),
    ("vertices", "<f4", (3, 3)),
    ("attr", "<u2"),
])


def euler_xyz_matrix(rot) -> np.ndarray:
    """Rotation matrix from Euler angles, matching object.c:550-562."""
    rx, ry, rz = (np.float32(r) for r in rot)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    a = cz * sy
    b = sz * sy
    return np.array([
        [cz * cy, a * sx - sz * cx, a * cx + sz * sx],
        [sz * cy, b * sx + cz * cx, b * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ], dtype=np.float32)


def load_stl(path: str, position=(0, 0, 0), rotation=(0, 0, 0),
             scale: float = 1.0) -> np.ndarray:
    """Load a binary STL and return transformed vertices (N, 3, 3)."""
    with open(path, "rb") as f:
        head = f.read(80)
        if len(head) < 5:
            raise ValueError(f"Failed to read header of mesh file [{path}].")
        if head[:5] == b"solid":
            raise ValueError(
                f"Mesh file [{path}] does not use binary encoding.")
        n = int(np.frombuffer(f.read(4), dtype="<u4")[0])
        data = np.frombuffer(f.read(n * _STL_DTYPE.itemsize), dtype=_STL_DTYPE)
        if data.shape[0] != n:
            raise ValueError(f"Failed to read triangle in mesh file [{path}].")

    verts = np.ascontiguousarray(data["vertices"]).astype(np.float32)
    rot = euler_xyz_matrix(rotation)
    # rotate, then scale, then translate (object.c:574-580)
    verts = np.einsum("ij,nvj->nvi", rot, verts) * np.float32(scale)
    verts = verts + np.asarray(position, np.float32)
    return verts


def save_stl(path: str, tri_vertices: np.ndarray) -> None:
    """Write a binary STL (used by tools/gen_meshes.py to create substitute
    meshes for the dragon/menger files missing from the reference mount)."""
    tri_vertices = np.asarray(tri_vertices, np.float32).reshape(-1, 3, 3)
    n = tri_vertices.shape[0]
    rec = np.zeros(n, dtype=_STL_DTYPE)
    e1 = tri_vertices[:, 1] - tri_vertices[:, 0]
    e2 = tri_vertices[:, 2] - tri_vertices[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-30)
    rec["normal"] = nrm
    rec["vertices"] = tri_vertices
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(np.uint32(n).tobytes())
        f.write(rec.tobytes())

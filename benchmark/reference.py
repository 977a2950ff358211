"""The plain reference of the renderer: what a frame and a gradient step
should give, written from the semantics of the reference C raytracer
(wojciech-graj/C-Raytracer: render.c, object.c, accel.c, material.c,
image.c) in plain PyTorch and NumPy, for the benchmark's check of
``correct``.

It imports nothing of the program.  From a configuration file (a scene
JSON with the benchmark's keys beside the scene's) it builds the scene
itself: the materials, the objects, the STL mesh (its bytes checked
against the configuration's hash), the automatic epsilons and the camera.
It renders with brute force where a scene is small and, for triangles,
with an exact culling of its own: triangles in Morton order, clusters of
``CLUSTER`` and a slab test of every segment against every cluster box,
inflated so that it never drops a hit; every candidate is then tested.
No visit budget, no shortlist: nothing is truncated.

What it shares with the program is the contract of its draws, which a
comparison pixel by pixel needs: uniforms from Philox4x32-10 keyed by the
sample path ``(tile, round, emitter, chunk)`` (and ``(tile, round, -1,
sample, 0)`` / ``(tile, round, -1, sample, 1, emitter, chunk)`` for path
GI), each draw a whole tile's ``(2, lc, P)`` array whose element
``(k, s, p)`` belongs to lane ``p`` of the tile; tiles of 65,536 pixels,
or 2,048 in a scene of 512 triangles or more; a pixel's pending rays
popped depth first, refraction pushed before reflection, at most
``stack_size`` pending.

Every float tensor is made in ``dtype``: float32 is the reference, and
the benchmark's frame controls run the same code in bfloat16.  With
``shade_dtype`` the direct light's arithmetic (each light sample's
attenuation, diffuse and specular terms and their sums) runs in that type
instead, the geometry, the occlusion and the colour's sums over rounds in
``dtype``: the step cell's control, since all in bfloat16 the specular
power of non-unit vectors overflows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

PI = float(np.float32(3.1415927))            # type.h
PI2 = float(np.float32(2.0) * np.float32(PI))
GI_TAG = -1
DENSE_TILE, CLUSTER_TILE = 65536, 2048
CLUSTER_TILE_FROM = 512       # triangles from which a scene takes 2,048
CLUSTER = 32                  # triangles a culling cluster
CHUNK = 1 << 24               # elements of one broadcast test
_M32, _M64 = 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF
TEX_UNIFORM, TEX_CHECKER = "uniform", "checkerboard"
MATERIAL_FIELDS = ("ks", "ka", "kr", "kt", "ke", "shininess",
                   "refractive_index", "tex_color", "tex_color2",
                   "tex_scale", "tex_p1", "tex_p2")


# -- draws: Philox4x32-10 keyed by splitmix64 of (seed, path) -------------

def _mulhilo(a: int, b):
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    return (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16),
            ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF))


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _key(seed: int, path: tuple):
    h = _splitmix64(int(seed) & _M64)
    for p in (len(path),) + tuple(path):
        h = _splitmix64(h ^ (int(p) & _M64))
    return h & _M32, h >> 32


def uniform_at(seed: int, path: tuple, index) -> torch.Tensor:
    """U[0,1) float32 at the flat ``index`` (int64) of the draw of
    (seed, path): element i is word i % 4 of block i // 4 of the
    Philox4x32-10 stream keyed by splitmix64 of (seed, path), as
    (w >> 8)·2^-24."""
    k0, k1 = _key(seed, path)
    block = index // 4
    zero = torch.zeros_like(block)
    words = torch.stack(_philox(block & _M32, block >> 32, zero, zero, k0,
                                k1), -1)
    w = words.gather(-1, (index % 4)[..., None])[..., 0]
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def tile_draw(seed: int, path: tuple, rows: int, P: int, lanes):
    """Rows ``(rows, len(lanes))`` of a tile's ``(rows, P)`` draw (a
    ``(2, lc, P)`` draw is 2·lc rows) at the tile's ``lanes``."""
    r = torch.arange(rows, device=lanes.device)[:, None]
    return uniform_at(seed, path, r * P + lanes[None])


# -- C float semantics ------------------------------------------------------

class _Fmax0Powf(torch.autograd.Function):
    """fmaxf(0, powf(x, s)) with C99's powf of negative and zero bases;
    its gradient on the lanes where it is positive: s·p/x and p·log|x|."""

    @staticmethod
    def forward(ctx, x, s):
        zero = x == 0
        mag = torch.where(zero, 1.0, x.abs()) ** s
        mag = torch.where(zero, torch.where(s > 0, 0.0, torch.where(
            s == 0, 1.0, float("inf"))).to(x.dtype), mag)
        odd = torch.remainder(s.abs(), 2.0) == 1.0
        neg = torch.where(s == torch.floor(s), torch.where(odd, -mag, mag),
                          float("nan"))
        p = torch.where(x < 0, neg, mag)
        p = torch.where(p > 0, p, 0.0)
        ctx.save_for_backward(x, s, p)
        return p

    @staticmethod
    def backward(ctx, g):
        x, s, p = ctx.saved_tensors
        on = (p > 0) & (x != 0)
        sx = torch.where(x == 0, 1.0, x)
        return (torch.where(on, s * p / sx * g, 0.0),
                torch.where(on, p * torch.log(sx.abs()) * g, 0.0))


def fmax0_powf(x, s):
    shape = torch.broadcast_shapes(x.shape, s.shape)
    return _Fmax0Powf.apply(x.expand(shape), s.expand(shape))


def _sqrt(x):
    """Correctly rounded in float32 (through float64); in ``x``'s type
    otherwise."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _safe_mag(a):
    m2 = _dot(a, a)
    ok = m2 > 0
    return torch.where(ok, _sqrt(torch.where(ok, m2, 1.0)), 0.0)


def _spherical(r, incl, azim):
    si, ci = torch.sin(incl), torch.cos(incl)
    sa, ca = torch.sin(azim), torch.cos(azim)
    return torch.stack([r * ca * si, r * sa * si, r * ci], -1)


# -- the scene --------------------------------------------------------------

_STL = np.dtype([("normal", "<f4", (3,)), ("vertices", "<f4", (3, 3)),
                 ("attr", "<u2")])


def _stl(path: str, sha256: str, position, rotation, scale) -> np.ndarray:
    """A binary STL's triangles, rotated (Euler XYZ), scaled, moved
    (object.c:521-587)."""
    with open(path, "rb") as f:
        raw = f.read()
    if hashlib.sha256(raw).hexdigest() != sha256:
        raise ValueError(f"{path}: not the mesh the configuration names")
    n = int(np.frombuffer(raw[80:84], "<u4")[0])
    v = np.frombuffer(raw[84:84 + n * _STL.itemsize], _STL)["vertices"]
    rx, ry, rz = (np.float32(r) for r in rotation)
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    a, b = cz * sy, sz * sy
    rot = np.array([[cz * cy, a * sx - sz * cx, a * cx + sz * sx],
                    [sz * cy, b * sx + cz * cx, b * cx - cz * sx],
                    [-sy, cy * sx, cy * cx]], np.float32)
    v = np.einsum("ij,nvj->nvi", rot, v.astype(np.float32)) * np.float32(
        scale)
    return (v + np.asarray(position, np.float32)).astype(np.float32)


@dataclasses.dataclass
class Scene:
    """Host tables of a scene and its float32 leaves, named as the
    program's ``SceneParams`` leaves (``materials.ks``, ``camera.fov``,
    ...).  Global primitive ids: spheres, triangles, planes."""

    leaves: dict
    ns: int
    nt: int
    npl: int
    mat: np.ndarray           # (N,) material of each primitive
    eps: np.ndarray           # (N,) float32
    lights: np.ndarray        # (N,) light samples
    emitters: list            # gids of emissive primitives
    tex: list                 # (M,) texture kind
    reflective: np.ndarray    # (M,) bool
    transparent: np.ndarray   # (M,) bool
    order: np.ndarray         # triangles in Morton order (culling only)


def load(config_path: str, root: str = ".") -> Scene:
    """The scene of a configuration file; mesh paths are relative to
    ``root``."""
    with open(config_path) as f:
        doc = json.load(f)
    f32 = np.float32
    ids = {}
    mats = []
    for i, m in enumerate(doc["Materials"]):
        ids.setdefault(int(m["id"]), i)
        t = m["texture"]
        if t["type"] == TEX_UNIFORM:
            c0, c1, sc = t["color"], [0, 0, 0], 0.0
        elif t["type"] == TEX_CHECKER:
            (c0, c1), sc = t["colors"], t["scale"]
        else:
            raise ValueError(f"texture {t['type']!r}: not in the reference")
        mats.append(dict(ks=m["ks"], ka=m["ka"], kr=m["kr"], kt=m["kt"],
                         ke=m["ke"], shininess=m["shininess"],
                         refractive_index=m["refractive_index"],
                         tex_color=c0, tex_color2=c1, tex_scale=sc,
                         tex_p1=0.0, tex_p2=0.0, tex=t["type"]))
    sph, tri, pln = [], [], []
    for ob in doc["Objects"]:
        p = ob["parameters"]
        mi = ids[int(p["material"])]
        eps = float(p.get("epsilon", -1.0))
        nl = int(p.get("lights", 0))
        if ob["type"] == "Sphere":
            sph.append((p["position"], p["radius"], mi, eps, nl))
        elif ob["type"] == "Plane":
            pln.append((p["position"], p["normal"], mi, eps))
        elif ob["type"] == "Triangle":
            tri.append(([p["vertex_1"], p["vertex_2"], p["vertex_3"]], mi,
                        eps, nl))
        elif ob["type"] == "Mesh":
            v = _stl(os.path.join(root, p["filename"]),
                     doc["mesh_sha256"][p["filename"]], p["position"],
                     p["rotation"], p["scale"])
            tri += [(t, mi, eps, nl) for t in v]
        else:
            raise ValueError(f"object {ob['type']!r}: not in the reference")
    ns, nt, npl = len(sph), len(tri), len(pln)
    sc = np.asarray([s[0] for s in sph], f32).reshape(ns, 3)
    sr = np.asarray([s[1] for s in sph], f32).reshape(ns)
    tv = np.asarray([t[0] for t in tri], f32).reshape(nt, 3, 3)
    pn = np.asarray([p[1] for p in pln], f32).reshape(npl, 3)
    pp = np.asarray([p[0] for p in pln], f32).reshape(npl, 3)
    pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
    pd = np.sum(pn * pp, axis=-1)
    # automatic epsilons (object.c:235-237, 336-339, 453-454)
    e_s = np.asarray([s[3] for s in sph], f32)
    e_t = np.asarray([t[2] for t in tri], f32)
    e_p = np.asarray([p[3] for p in pln], f32)
    area = 0.5 * np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0],
                                         tv[:, 2] - tv[:, 0]), axis=-1)
    eps = np.concatenate([
        np.where(e_s == -1.0, sr * f32(0.0003), e_s),
        np.where(e_t == -1.0, f32(0.003) * area.astype(f32) ** 0.75, e_t),
        np.where(e_p == -1.0, f32(1e-6), e_p)]).astype(f32)
    mat = np.asarray([s[2] for s in sph] + [t[1] for t in tri]
                     + [p[2] for p in pln], np.int64)
    lights = np.asarray([s[4] for s in sph] + [t[3] for t in tri]
                        + [0] * npl, np.int64)
    col = {k: np.asarray([m[k] for m in mats], f32) for k in MATERIAL_FIELDS}
    norm = {k: np.linalg.norm(col[k], axis=-1) > 1e-6
            for k in ("kr", "kt", "ke")}
    cam = doc["Camera"]
    vx = np.asarray(cam["vector_x"], f32)
    vy = np.asarray(cam["vector_y"], f32)
    leaves = {"sphere_center": sc, "sphere_radius": sr, "tri_vertices": tv,
              "plane_normal": pn.astype(f32), "plane_d": pd.astype(f32),
              "ambient": np.asarray(doc.get("AmbientLight", [0, 0, 0]), f32)}
    leaves.update({f"materials.{k}": v for k, v in col.items()})
    leaves.update({
        "camera.position": np.asarray(cam["position"], f32),
        "camera.vector_x": (vx / np.linalg.norm(vx)).astype(f32),
        "camera.vector_y": (vy / np.linalg.norm(vy)).astype(f32),
        "camera.fov": f32(cam["fov"]),
        "camera.focal_length": f32(cam["focal_length"])})
    return Scene(
        leaves={k: np.asarray(v, f32) for k, v in leaves.items()},
        ns=ns, nt=nt, npl=npl, mat=mat, eps=eps, lights=lights,
        emitters=[g for g in range(ns + nt) if norm["ke"][mat[g]]],
        tex=[m["tex"] for m in mats], reflective=norm["kr"],
        transparent=norm["kt"], order=_morton(tv))


def _morton(tv: np.ndarray) -> np.ndarray:
    """Triangles sorted by the 30-bit Morton code of their box centres."""
    if not len(tv):
        return np.zeros(0, np.int64)
    c = 0.5 * (tv.min(1) + tv.max(1))
    span = c.max(0) - c.min(0)
    q = np.clip((c - c.min(0)) / np.where(span > 0, span, 1) * 1024, 0,
                1023).astype(np.uint64)
    code = np.zeros(len(c), np.uint64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> np.uint64(bit)) & np.uint64(1)) << \
                np.uint64(3 * bit + 2 - ax)
    return np.argsort(code, kind="stable")


def device_leaves(scene: Scene, device, dtype=torch.float32) -> dict:
    """The scene's leaves as tensors of ``dtype`` on ``device``."""
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in scene.leaves.items()}


# -- one frame --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Flags:
    """The render flags of the reference's CLI (main.c:35-53)."""

    max_bounces: int = 10
    min_light_intensity: float = 0.01
    reflection_model: str = "phong"
    gi_model: str = "ambient"
    samples_per_pixel: int = 1
    light_attenuation: str = "sqr"
    attenuation_offset: float = 1.0
    light_chunk: int = 40
    stack_size: int = 8


class _Frame:
    """What one frame derives from the leaves: triangle edges, normals and
    culling boxes, per-primitive tables on the device."""

    def __init__(self, scene: Scene, leaves: dict, flags: Flags, device,
                 dtype, shade_dtype=None):
        self.s, self.L, self.f = scene, leaves, flags
        self.dev, self.dt = torch.device(device), dtype
        self.sdt = shade_dtype or dtype
        self.big = torch.finfo(dtype).max     # a miss's t
        self.mat = torch.as_tensor(scene.mat, device=device)
        self.eps = torch.as_tensor(scene.eps, device=device).to(dtype)
        self.refl = torch.as_tensor(scene.reflective, device=device)
        self.transp = torch.as_tensor(scene.transparent, device=device)
        self.slots = [m for m, t in enumerate(scene.transparent) if t]
        tv = leaves["tri_vertices"]
        self.v0, self.e1 = tv[:, 0], tv[:, 1] - tv[:, 0]
        self.e2 = tv[:, 2] - tv[:, 0]
        n = _cross(self.e1, self.e2)
        self.tn = n / torch.clamp(_sqrt(_dot(n, n)), min=1e-30)[:, None]
        ns, nt = scene.ns, scene.nt
        if nt:
            order = torch.as_tensor(scene.order, device=device)
            k = -(-nt // CLUSTER)
            pad = torch.full((k * CLUSTER - nt,), -1, dtype=torch.int64,
                             device=device)
            self.members = torch.cat([order, pad]).reshape(k, CLUSTER)
            vv = tv.detach()[self.members.clamp(min=0)]     # (k, C, 3, 3)
            ok = (self.members >= 0)[:, :, None, None]
            lo = torch.where(ok, vv, self.big).amin((1, 2)).float()
            hi = torch.where(ok, vv, -self.big).amax((1, 2)).float()
            margin = 1e-4 * float((hi.amax(0) - lo.amin(0)).max()) + 1e-6
            self.lo, self.hi = lo - margin, hi + margin
            self.tri_transp = self.transp[self.mat[ns:ns + nt]]
            slot_of = torch.full((len(scene.transparent),), -1,
                                 dtype=torch.int64, device=device)
            for i, m in enumerate(self.slots):
                slot_of[m] = i
            self.tri_slot = slot_of[self.mat[ns:ns + nt]]

    def m(self, name, idx):
        return self.L[f"materials.{name}"][idx]

    # -- intersection ----------------------------------------------------

    def _sphere(self, o, d, i):
        c, r = self.L["sphere_center"][i], self.L["sphere_radius"][i]
        rel = o - c
        b = -_dot(d, rel)
        det = b * b - (_dot(rel, rel) - r * r)
        ok = det > 0
        sq = torch.where(ok, _sqrt(torch.where(ok, det, 1.0)), 0.0)
        t = torch.where(b - sq > self.eps[i], b - sq, b + sq)
        return t, (det >= 0) & (t > self.eps[i])

    def _plane(self, o, d, i):
        n, g = self.L["plane_normal"][i], self.s.ns + self.s.nt + i
        a = _dot(d, n)
        par = a.abs() < self.eps[g]
        t = (self.L["plane_d"][i] - _dot(o, n)) / torch.where(par, 1.0, a)
        return t, ~par & (t > self.eps[g]), a

    def _mt(self, o, d, v0, e1, e2, eps):
        """Möller-Trumbore (object.c:422-441)."""
        h = _cross(d, e2)
        a = _dot(e1, h)
        par = (a < eps) & (a > -eps)
        f = 1.0 / torch.where(par, 1.0, a)
        s = o - v0
        u = f * _dot(s, h)
        q = _cross(s, e1)
        v = f * _dot(d, q)
        t = f * _dot(e2, q)
        return t, ~par & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (
            t > eps)

    def _pairs(self, o, d, tmax):
        """(ray, cluster) pairs whose inflated box the segment [0, tmax]
        of the ray meets."""
        K = self.lo.shape[0]
        rays, cl = [], []
        step = max(1, CHUNK // K)
        od, dd = o.detach().float(), d.detach().float()
        dd = torch.where(dd.abs() < 1e-30, 1e-30, dd)
        inv, tm = 1.0 / dd, tmax.detach().float()
        lo, hi = self.lo.float(), self.hi.float()
        for r0 in range(0, o.shape[0], step):
            sl = slice(r0, r0 + step)
            t1 = (lo[None] - od[sl, None]) * inv[sl, None]
            t2 = (hi[None] - od[sl, None]) * inv[sl, None]
            near = torch.minimum(t1, t2).amax(-1)
            far = torch.maximum(t1, t2).amin(-1)
            hit = (near <= far) & (far >= 0) & (near <= tm[sl, None])
            r, c = hit.nonzero(as_tuple=True)
            rays.append(r + r0)
            cl.append(c)
        return torch.cat(rays), torch.cat(cl)

    def _tri_candidates(self, o, d, tmax):
        """Every (ray, triangle) that the culling keeps, tested: (ray,
        triangle, t, hit), in chunks."""
        r, c = self._pairs(o, d, tmax)
        tri = self.members[c].reshape(-1)
        r = r[:, None].expand(-1, CLUSTER).reshape(-1)
        keep = tri >= 0
        r, tri = r[keep], tri[keep]
        ts, hs = [], []
        for a in range(0, r.shape[0], CHUNK // 8):
            rr, tt = r[a:a + CHUNK // 8], tri[a:a + CHUNK // 8]
            t, h = self._mt(o[rr], d[rr], self.v0[tt], self.e1[tt],
                            self.e2[tt], self.eps[self.s.ns + tt])
            ts.append(t)
            hs.append(h)
        if not ts:
            z = o.new_zeros((0,))
            return r, tri, z, z.bool()
        return r, tri, torch.cat(ts), torch.cat(hs)

    def closest(self, o, d):
        """(t, gid, normal) of the nearest hit; on a miss t is the type's
        largest float (FLT_MAX in float32) and gid -1.  Planes, then
        spheres, then triangles; a later primitive wins on a strictly
        smaller t only (accel.c:328)."""
        s = self.s
        n_r = o.shape[0]
        bt = o.new_full((n_r,), self.big)
        bg = torch.full((n_r,), -1, dtype=torch.int64, device=self.dev)
        bn = o.new_zeros((n_r, 3))
        for i in range(s.npl):
            t, hit, a = self._plane(o, d, i)
            t = torch.where(hit, t, self.big)
            better = t < bt
            n = self.L["plane_normal"][i] * torch.where(
                torch.signbit(a), 1.0, -1.0).to(self.dt)[:, None]
            bt, bg = torch.where(better, t, bt), torch.where(
                better, s.ns + s.nt + i, bg)
            bn = torch.where(better[:, None], n, bn)
        for i in range(s.ns):
            t, hit = self._sphere(o, d, i)
            t = torch.where(hit, t, self.big)
            better = t < bt
            tn = torch.where(t < self.big, t, 1.0)
            n = (o + d * tn[:, None] - self.L["sphere_center"][i]) * (
                1.0 / self.L["sphere_radius"][i])
            bt, bg = torch.where(better, t, bt), torch.where(better, i, bg)
            bn = torch.where(better[:, None], n, bn)
        if s.nt:
            r, tri, t, hit = self._tri_candidates(o, d, bt)
            t = torch.where(hit, t, self.big)
            tmin = bt.detach().clone().scatter_reduce(
                0, r, t.detach(), "amin")
            win = hit & (t.detach() == tmin[r]) & (t.detach() < bt[r].detach())
            first = torch.full((n_r,), 1 << 62, dtype=torch.int64,
                               device=self.dev).scatter_reduce(
                0, r[win], tri[win], "amin")
            has = first < (1 << 62)
            sel = win & (tri == first[r])
            tt = bt.index_put((r[sel],), t[sel])
            bt = torch.where(has, tt, bt)
            ti = first.clamp(max=s.nt - 1)
            bg = torch.where(has, s.ns + ti, bg)
            bn = torch.where(has[:, None], self.tn[ti], bn)
        return bt, bg, bn

    def retest(self, o, d, gid):
        """Primitive ``gid`` of each ray alone (render.c:143-144); gid -1
        misses.  Returns (t, hit, normal)."""
        s = self.s
        g = gid.clamp(min=0)
        t = o.new_zeros(o.shape[0])
        hit = torch.zeros_like(gid, dtype=torch.bool)
        n = o.new_zeros(o.shape)
        if s.ns:
            i = g.clamp(max=s.ns - 1)
            c, r = self.L["sphere_center"][i], self.L["sphere_radius"][i]
            rel = o - c
            b = -_dot(d, rel)
            det = b * b - (_dot(rel, rel) - r * r)
            ok = det > 0
            sq = torch.where(ok, _sqrt(torch.where(ok, det, 1.0)), 0.0)
            e = self.eps[i]
            st = torch.where(b - sq > e, b - sq, b + sq)
            m = gid < s.ns
            t = torch.where(m, st, t)
            hit = torch.where(m, (det >= 0) & (st > e), hit)
            n = torch.where(m[:, None], (o + d * st[:, None] - c)
                            / r[:, None], n)
        if s.nt:
            k = (g - s.ns).clamp(0, s.nt - 1)
            tt, th = self._mt(o, d, self.v0[k], self.e1[k], self.e2[k],
                              self.eps[s.ns + k])
            m = (gid >= s.ns) & (gid < s.ns + s.nt)
            t = torch.where(m, tt, t)
            hit = torch.where(m, th, hit)
            n = torch.where(m[:, None], self.tn[k], n)
        if s.npl:
            k = (g - s.ns - s.nt).clamp(0, s.npl - 1)
            pn = self.L["plane_normal"][k]
            a = _dot(d, pn)
            e = self.eps[s.ns + s.nt + k]
            par = a.abs() < e
            pt = (self.L["plane_d"][k] - _dot(o, pn)) / torch.where(
                par, 1.0, a)
            m = gid >= s.ns + s.nt
            t = torch.where(m, pt, t)
            hit = torch.where(m, ~par & (pt > e), hit)
            n = torch.where(m[:, None], torch.where(
                torch.signbit(a)[:, None], pn, -pn), n)
        return t, hit & (gid >= 0), n

    def occlusion(self, o, ldir, ldist, egid):
        """Shadow segments from o (L, 3) along ldir (S, L, 3) to ldist
        (S, L): (blocked (S, L), counts (S, L, slots)); opaque hits before
        the end block, each transparent one counts (accel.c:360-387); the
        emitter itself is skipped."""
        s = self.s
        S, L = ldist.shape
        blocked = torch.zeros((S, L), dtype=torch.bool, device=self.dev)
        counts = torch.zeros((S, L, len(self.slots)), dtype=torch.int64,
                             device=self.dev)
        ob = o[None].expand(S, L, 3)

        def fold(t, hit, g):
            nonlocal blocked, counts
            if g == egid:
                return
            inr = hit & (t < ldist)
            mi = int(s.mat[g])
            if s.transparent[mi]:
                counts[..., self.slots.index(mi)] += inr
            else:
                blocked = blocked | inr

        for i in range(s.npl):
            t, hit, _ = self._plane(ob, ldir, i)
            fold(t, hit, s.ns + s.nt + i)
        for i in range(s.ns):
            fold(*self._sphere(ob, ldir, i), i)
        if s.nt:
            fo, fd = ob.reshape(-1, 3), ldir.reshape(-1, 3)
            fm = ldist.reshape(-1)
            r, tri, t, hit = self._tri_candidates(fo, fd, fm)
            inr = hit & (t < fm[r]) & (s.ns + tri != egid)
            op = inr & ~self.tri_transp[tri]
            fb = torch.zeros(S * L, dtype=torch.bool, device=self.dev)
            fb[r[op]] = True
            blocked = blocked | fb.reshape(S, L)
            tr = inr & self.tri_transp[tri]
            if self.slots:
                fc = torch.zeros((S * L, len(self.slots)), dtype=torch.int64,
                                 device=self.dev)
                fc.index_put_((r[tr], self.tri_slot[tri[tr]]),
                              torch.ones_like(r[tr]), accumulate=True)
                counts = counts + fc.reshape(S, L, -1)
        return blocked, counts

    # -- shading ---------------------------------------------------------

    def texture(self, mat, p):
        out = p.new_zeros(p.shape)
        for m, kind in enumerate(self.s.tex):
            c0 = self.L["materials.tex_color"][m]
            if kind == TEX_CHECKER:
                sp = p * self.L["materials.tex_scale"][m]
                par = (sp[:, 0].to(torch.int32) + sp[:, 1].to(torch.int32)
                       + sp[:, 2].to(torch.int32)) % 2
                col = torch.where((par != 0)[:, None],
                                  self.L["materials.tex_color2"][m], c0)
            else:
                col = c0.expand(p.shape)
            out = torch.where((mat == m)[:, None], col, out)
        return out

    def attenuate(self, c, dist):
        f = self.f
        off = float(np.float32(f.attenuation_offset))
        if f.light_attenuation == "none":
            return c
        if f.light_attenuation == "lin":
            return c * (1.0 / (off + dist))[..., None]
        return c * (1.0 / (off + dist * dist))[..., None]

    def attenuate_segment(self, c, t):
        f = self.f
        off = float(np.float32(f.attenuation_offset))
        if f.light_attenuation == "none":
            return c
        if f.light_attenuation == "lin":
            return c * (1.0 / (off + t))[:, None]
        return c * (1.0 / ((off + t) * (off + t)))[:, None]

    def direct(self, seed, path, P, pos, hit_pt, n, rd, gid, mat, outside,
               tex):
        """Soft-shadow direct light of every emitter (render.c:170-229) at
        lanes ``pos`` of a tile of ``P``, drawn under ``path``."""
        s, f, sd = self.s, self.f, self.sdt
        total = hit_pt.new_zeros(hit_pt.shape, dtype=sd)
        ks = self.m("ks", mat).to(sd)
        shin = self.m("shininess", mat).to(sd)
        tex = tex.to(sd)
        for e_i, eg in enumerate(s.emitters):
            nl = int(s.lights[eg])
            if nl == 0:
                continue
            lc = min(f.light_chunk, -(-nl // 8) * 8)
            sh = outside & (gid != eg)
            idx = sh.nonzero()[:, 0]
            if not len(idx):
                continue
            o, nn, dd = hit_pt[idx], n[idx].to(sd), rd[idx].to(sd)
            inten = self.m("ke", int(s.mat[eg])).to(sd) * float(
                np.float32(1) / np.float32(nl))
            acc = o.new_zeros(o.shape, dtype=sd)
            for c in range(-(-nl // lc)):
                u = tile_draw(seed, path + (e_i, c), 2 * lc, P,
                              pos[idx]).reshape(2, lc, -1).to(self.dt)
                if eg < s.ns:
                    cen = self.L["sphere_center"][eg]
                    ld = _spherical(self.L["sphere_radius"][eg], u[0] * PI2,
                                    u[1] * PI2)
                    flip = _dot((cen - o)[None], ld) != 0.0
                    lp = torch.where(flip[..., None], -ld, ld) + cen
                else:
                    k = eg - s.ns
                    a_, b_ = u[0], u[1]
                    over = a_ + b_ > 1.0
                    a_ = torch.where(over, 1.0 - a_, a_)
                    b_ = torch.where(over, 1.0 - b_, b_)
                    lp = (self.v0[k] + self.e1[k] * a_[..., None]
                          + self.e2[k] * b_[..., None])
                lv = lp - o[None]
                ldist = _safe_mag(lv)
                ldir = lv * (1.0 / torch.where(ldist == 0.0, 1.0,
                                               ldist))[..., None]
                with torch.no_grad():
                    blocked, counts = self.occlusion(o, ldir.detach(),
                                                     ldist.detach(), eg)
                ldir, ldist = ldir.to(sd), ldist.to(sd)
                it = inten.expand(ldist.shape + (3,))
                for j, m in enumerate(self.slots):
                    it = it * torch.pow(self.L["materials.kt"][m].to(sd),
                                        counts[..., j, None].to(sd))
                inc = self.attenuate(it, ldist)
                a = _dot(ldir, nn[None])
                if f.reflection_model == "phong":
                    spec_mul = -_dot(nn[None] * (2.0 * a)[..., None] - ldir,
                                     dd[None])
                else:
                    hv = dd[None] - ldir
                    hm = _safe_mag(hv)
                    spec_mul = -_dot(nn[None], hv * (1.0 / torch.where(
                        hm == 0.0, 1.0, hm))[..., None])
                cos_d = torch.where(a > 0, a, 0.0)
                spec_p = fmax0_powf(spec_mul, shin[idx][None])
                contrib = (tex[idx][None] * inc * cos_d[..., None]
                           + ks[idx][None] * inc * spec_p[..., None])
                real = (c * lc + torch.arange(lc, device=self.dev)
                        < nl)[:, None] & ~blocked
                acc = acc + torch.where(real[..., None], contrib, 0.0).sum(0)
            total = total.index_put((idx,), acc, accumulate=True)
        return total

    def shade(self, seed, path, P, pos, o, d, t, gid, n):
        """Emission + direct light at the lanes that hit (gid >= 0).
        Returns (colour, hit point, n·d, outside)."""
        hit = gid >= 0
        mat = self.mat[gid.clamp(min=0)]
        t = torch.where(hit, t, 1.0)
        hit_pt = o + d * t[:, None]
        b = _dot(n, d)
        outside = torch.signbit(b)
        tex = self.texture(mat, hit_pt)
        color = self.m("ke", mat) + self.direct(
            seed, path, P, pos, hit_pt, n, d, gid, mat, outside & hit,
            tex).to(self.dt)
        return torch.where(hit[:, None], color, 0.0), hit_pt, b, outside

    def hemisphere(self, seed, path, P, pos, n, eps):
        """A path-GI direction (render.c:238-283): (dir, cos)."""
        u = tile_draw(seed, path, 2, P, pos).to(self.dt)
        lo = _spherical(1.0, torch.arccos(u[0] * 2.0 - 1.0), u[1] * PI)
        nx, ny, nz = n.unbind(-1)
        down = (ny - eps) < -1.0
        mul = 1.0 / torch.where(down, 1.0, 1.0 + ny)
        rx = torch.stack([1.0 - nx * nx * mul, nx, -nx * nz * mul], -1)
        ry = torch.stack([-nx, 1.0 - (nx * nx + nz * nz) * mul, -nz], -1)
        rz = torch.stack([-nx * nz * mul, nz, 1.0 - nz * nz * mul], -1)
        dr = torch.stack([_dot(rx, lo), _dot(ry, lo), _dot(rz, lo)], -1)
        flip = torch.stack([lo[:, 0], -lo[:, 1], -lo[:, 2]], -1)
        dr = torch.where(down[:, None], flip, dr)
        return dr, _dot(n, dr)

    def refract(self, d, n, b, outside, ior):
        """Snell rotation in the plane of incidence (render.c:324-337):
        (direction, valid); total internal reflection and normal incidence
        are not valid."""
        ab = b.abs()
        inner = ab < 1.0
        inc = torch.where(inner, torch.arccos(torch.where(inner, ab, 0.5)),
                          0.0)
        sin_r = torch.sin(inc) * torch.where(outside, 1.0 / ior, ior)
        tir = sin_r.abs() > 1.0
        si = sin_r.abs() < 1.0
        rr = torch.where(si, torch.arcsin(torch.where(si, sin_r, 0.5)),
                         torch.where(sin_r > 0, PI / 2, -PI / 2).to(self.dt))
        delta = rr - inc
        cr = _cross(d, n)
        m = _safe_mag(cr)
        degen = m == 0.0
        c = cr * (1.0 / torch.where(degen, 1.0, m))[:, None]
        c = torch.where(outside[:, None], c, -c)
        out = d * torch.cos(delta)[:, None] + _cross(c, d) * torch.sin(
            delta)[:, None]
        om = _safe_mag(out)
        return out * (1.0 / torch.where(om == 0.0, 1.0, om))[:, None], ~(
            tir | degen)

    def gi(self, seed, path, P, pos, hit_pt, n, gid, outside, rem, hit):
        """Path GI (render.c:238-287): spp samples at primary hits, one at
        secondary hits, each a traced child shaded by emission and direct
        light, weighted by δ·cos and the child's segment attenuation."""
        f = self.f
        spp = max(f.samples_per_pixel, 1)
        prim = rem == f.max_bounces
        eps = self.eps[gid.clamp(min=0)]
        on = hit & outside & (rem > 0)
        delta = torch.where(prim, float(np.float32(1) / np.float32(spp)),
                            1.0).to(self.dt)
        acc = hit_pt.new_zeros(hit_pt.shape)
        for i in range(spp):
            ok = on & (prim if i > 0 else True)
            idx = ok.nonzero()[:, 0]
            if not len(idx):
                continue
            sp = path + (GI_TAG, i)
            sd, cos = self.hemisphere(seed, sp + (0,), P, pos[idx], n[idx],
                                      eps[idx])
            ct, cg, cn = self.closest(hit_pt[idx], sd)
            child, _, _, _ = self.shade(seed, sp + (1,), P, pos[idx],
                                        hit_pt[idx], sd, ct, cg, cn)
            child = self.attenuate_segment(
                child * (delta[idx] * cos)[:, None], ct)
            child = torch.where((cg >= 0)[:, None], child, 0.0)
            acc = acc.index_put((idx,), child, accumulate=True)
        return acc


def primary_rays(L: dict, res_x: int, res_y: int):
    """Origins and unit directions of every pixel, row by row, with the
    reference's one-pixel X offset (image.c:34-56, render.c:352-366)."""
    vx0, vy0 = L["camera.vector_x"], L["camera.vector_y"]
    pos, fl = L["camera.position"], L["camera.focal_length"]
    vz = _cross(vx0, vy0)
    size_x = 2.0 * fl * torch.tan(L["camera.fov"] * (PI / 360.0))
    size_y = size_x * (res_y / res_x)
    vx, vy = vx0 * (size_x / res_x), vy0 * (size_y / res_y)
    corner = (pos + vz * fl + vx * (0.5 - res_x / 2.0)
              + vy * (0.5 - res_y / 2.0))
    cols = torch.arange(1, res_x + 1, device=pos.device).to(pos.dtype)
    rows = torch.arange(res_y, device=pos.device).to(pos.dtype)
    px = corner + cols[None, :, None] * vx + rows[:, None, None] * vy
    rel = (px - pos).reshape(-1, 3)
    d = rel / _sqrt(_dot(rel, rel))[:, None]
    return pos.expand(d.shape), d


def tile_size(scene: Scene, n_pixels: int) -> int:
    tile = CLUSTER_TILE if scene.nt >= CLUSTER_TILE_FROM else DENSE_TILE
    return min(tile, n_pixels)


def render_tile(fr: _Frame, seed: int, tile_i: int, P: int, o, d):
    """One tile's pixels (lanes 0..len(o)-1 of a tile of P): (colour,
    z).  A pixel's pending rays are popped depth first."""
    f, s = fr.f, fr.s
    n = o.shape[0]
    dev, dt = fr.dev, fr.dt
    transparent = bool(s.transparent.any())
    S = f.stack_size
    slot = torch.arange(S, device=dev)
    # the stack: (n, S) slots of origin, direction, weight, depth, inside
    st_o = torch.where((slot == 0)[None, :, None], o[:, None], 0.0)
    st_d = torch.where((slot == 0)[None, :, None], d[:, None], 0.0)
    st_k = torch.where((slot == 0)[None, :, None], 1.0, o.new_zeros(
        (n, S, 3)))
    st_r = torch.where(slot == 0, f.max_bounces, 0).expand(n, S)
    st_i = torch.full((n, S), -1, dtype=torch.int64, device=dev)
    count = torch.ones(n, dtype=torch.int64, device=dev)
    color = o.new_zeros((n, 3))
    z = o.new_zeros(n)
    thr = f.min_light_intensity * f.min_light_intensity
    rounds = 4 * f.max_bounces + 1 if transparent else f.max_bounces + 1
    for rnd in range(rounds):
        live = count > 0
        idx = live.nonzero()[:, 0]
        if not len(idx):
            break
        top = (count[idx] - 1)
        ro, rd, rk = (a[idx, top] for a in (st_o, st_d, st_k))
        rem, ins = st_r[idx, top], st_i[idx, top]
        count = count - live.long()
        t, gid, nrm = fr.closest(ro, rd)
        if transparent:
            ti, hi, ni = fr.retest(ro, rd, ins)
            use = (ins >= 0) & hi
            t = torch.where(use, ti, t)
            gid = torch.where(use, ins, gid)
            nrm = torch.where(use[:, None], ni, nrm)
        hit = gid >= 0
        mat = fr.mat[gid.clamp(min=0)]
        path = (tile_i, rnd)
        obj, hit_pt, b, outside = fr.shade(seed, path, P, idx, ro, rd, t,
                                           gid, nrm)
        if f.gi_model == "path":
            obj = obj + fr.gi(seed, path, P, idx, hit_pt, nrm, gid, outside,
                              rem, hit)
        else:
            obj = obj + torch.where(hit[:, None], fr.m("ka", mat)
                                    * fr.L["ambient"], 0.0)
        contrib = torch.where(hit[:, None],
                              fr.attenuate_segment(rk * obj, t), 0.0)
        color = color.index_put((idx,), contrib, accumulate=True)
        prim = rem == f.max_bounces
        zv = torch.where(hit & (rem > 0), t, 0.0)
        z = z.index_put((idx[prim],), zv[prim])
        bounce = hit & (rem > 0)
        kr = rk * fr.m("kr", mat)
        p_refl = bounce & fr.refl[mat] & (_dot(kr, kr) > thr) & (ins != gid)
        r_dir = rd - nrm * (2.0 * b)[:, None]
        pushes = []
        if transparent:
            kt = rk * fr.m("kt", mat)
            t_dir, valid = fr.refract(rd, nrm, b, outside,
                                      fr.m("refractive_index", mat))
            p_refr = bounce & fr.transp[mat] & valid & (_dot(kt, kt) > thr)
            pushes.append((p_refr, t_dir, kt, gid))
        pushes.append((p_refl, r_dir, kr, torch.full_like(gid, -1)))
        for push, nd, nk, nin in pushes:
            c = count[idx]
            ok = push & (c < S)
            w, at = idx[ok], c[ok]
            st_o = st_o.index_put((w, at), hit_pt[ok])
            st_d = st_d.index_put((w, at), nd[ok])
            st_k = st_k.index_put((w, at), nk[ok])
            st_r = st_r.index_put((w, at), rem[ok] - 1)
            st_i = st_i.index_put((w, at), nin[ok])
            count = count.index_put((w,), c[ok] + 1)
    return color, z


def render(scene: Scene, leaves: dict, flags: Flags, res_x: int,
           res_y: int, seed: int, *, device, dtype=torch.float32,
           shade_dtype=None):
    """A frame: (image (res_y, res_x, 3), z (res_y, res_x)) in ``dtype``."""
    fr = _Frame(scene, leaves, flags, device, dtype, shade_dtype)
    o, d = primary_rays(leaves, res_x, res_y)
    tile = tile_size(scene, res_x * res_y)
    cols, zs = [], []
    for i in range(-(-res_x * res_y // tile)):
        sl = slice(i * tile, (i + 1) * tile)
        c, z = render_tile(fr, seed, i, tile, o[sl], d[sl])
        cols.append(c)
        zs.append(z)
    return (torch.cat(cols).reshape(res_y, res_x, 3),
            torch.cat(zs).reshape(res_y, res_x))


def loss_and_grads(scene: Scene, leaves: dict, flags: Flags, res: int,
                   seed: int, target, *, device, dtype=torch.float32,
                   shade_dtype=None):
    """mean((image − target)²) and its gradient with respect to every
    leaf, tile by tile (each tile's graph is freed before the next)."""
    req = {k: v.detach().clone().requires_grad_(True)
           for k, v in leaves.items()}
    tile = tile_size(scene, res * res)
    n_el = res * res * 3
    total = 0.0
    tgt = target.reshape(-1, 3).to(dtype)
    for i in range(-(-res * res // tile)):
        fr = _Frame(scene, req, flags, device, dtype, shade_dtype)
        o, d = primary_rays(req, res, res)
        sl = slice(i * tile, (i + 1) * tile)
        c, _ = render_tile(fr, seed, i, tile, o[sl], d[sl])
        part = ((c - tgt[sl]) ** 2).sum() / n_el
        part.backward()
        total += float(part.detach())
        del fr, c, part
    return total, {k: (v.grad if v.grad is not None
                       else torch.zeros_like(v)).detach()
                   for k, v in req.items()}

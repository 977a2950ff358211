"""JSON scene loading with the reference's exact schema and validation.

Mirrors ``scene.c`` (scene.c:70-470): the shipped scene1-6.json files load
unmodified.  Host-side Python (stdlib json) replaces the vendored cJSON DOM
parser — config loading is not device code.

Error messages keep the reference's wording so CLI behavior matches
(error.h:21-33 semantics: fatal on any schema violation).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from c_raytracer_tpu_torch.scene import stl as stl_mod
from c_raytracer_tpu_torch.scene import types as T


class SceneError(ValueError):
    pass


def _err(cond, msg):
    if not cond:
        raise SceneError(msg)


def _get(parent: dict, token: str, typ, scene: str):
    val = parent.get(token)
    # JSON true/false must not satisfy a Number/other-typed token (bool is
    # an int subclass in Python; cJSON keeps the types distinct)
    ok = isinstance(val, typ) and not (typ is not bool and isinstance(val, bool))
    _err(ok, f"Expected token [{token}] of type [{typ}] in scene [{scene}].")
    return val


def _get_num(parent, token, scene):
    v = parent.get(token)
    _err(isinstance(v, (int, float)) and not isinstance(v, bool),
         f"Expected token [{token}] of type [Number] in scene [{scene}].")
    return v


def _get_arr(parent, token, length, scene):
    v = parent.get(token)
    _err(isinstance(v, list),
         f"Expected token [{token}] of type [Array] in scene [{scene}].")
    _err(len(v) == length,
         f"Expected token [{token}] of length [{length}] in scene [{scene}].")
    for x in v:
        _err(isinstance(x, (int, float)) and not isinstance(x, bool),
             f"Expected token in Array of type [Number] in scene [{scene}].")
    return [float(x) for x in v]


_TEX_NAMES = {
    "uniform": T.TEX_UNIFORM,
    "checkerboard": T.TEX_CHECKERBOARD,
    "brick": T.TEX_BRICK,
    "noisy periodic": T.TEX_NOISY_PERIODIC,
}
_FUNC_NAMES = {
    "sin": T.FUNC_SIN,
    "saw": T.FUNC_SAW,
    "triangle": T.FUNC_TRIANGLE,
    "square": T.FUNC_SQUARE,
}


def _texture_load(tex: dict, scene: str) -> dict:
    """Parse one texture object into the flat material dict fields
    (scene.c:195-293)."""
    tname = tex.get("type")
    _err(isinstance(tname, str),
         f"Expected token [type] of type [String] in scene [{scene}].")
    out: dict[str, Any] = {}
    if tname == "uniform":
        out["tex_type"] = T.TEX_UNIFORM
        out["tex_color"] = _get_arr(tex, "color", 3, scene)
    elif tname in ("checkerboard", "brick"):
        out["tex_type"] = _TEX_NAMES[tname]
        colors = tex.get("colors")
        _err(isinstance(colors, list) and len(colors) == 2,
             f"Expected token [colors] of length [2] in scene [{scene}].")
        for c in colors:
            _err(isinstance(c, list) and len(c) == 3,
                 f"Expected token in [colors] of length 3 in scene [{scene}].")
        out["tex_color"] = [float(x) for x in colors[0]]
        out["tex_color2"] = [float(x) for x in colors[1]]
        out["tex_scale"] = float(_get_num(tex, "scale", scene))
        if tname == "brick":
            out["tex_p1"] = float(_get_num(tex, "mortar width", scene))
    elif tname == "noisy periodic":
        out["tex_type"] = T.TEX_NOISY_PERIODIC
        out["tex_color"] = _get_arr(tex, "color", 3, scene)
        out["tex_color2"] = _get_arr(tex, "color gradient", 3, scene)
        out["tex_scale"] = float(_get_num(tex, "noise feature scale", scene))
        out["tex_p1"] = float(_get_num(tex, "noise scale", scene))
        out["tex_p2"] = float(_get_num(tex, "frequency scale", scene))
        fn = tex.get("function")
        _err(isinstance(fn, str),
             f"Expected token [function] of type [String] in scene [{scene}].")
        _err(fn in _FUNC_NAMES,
             f"Unexpected value [{fn}] of token [function] in scene [{scene}].")
        out["tex_func"] = _FUNC_NAMES[fn]
    else:
        raise SceneError(
            f"Unrecognized token [{tname}] in texture in scene [{scene}].")
    return out


def load_scene(path: str, scale: float | str | None = None,
               mesh_root: str | None = None) -> T.Scene:
    """Load a scene JSON file; returns a Scene bundle.

    ``scale``: None, a float, or "norm" — the -r flag (scene.c:109-121).
    ``mesh_root``: optional directory to resolve relative mesh paths against
    (the reference resolves relative to the CWD, main invocation from repo
    root; tests pass the reference root).
    """
    scene_name = path
    with open(path, "rb") as f:
        doc = json.load(f)
    _err(isinstance(doc, dict),
         f"Expected parent token of type Object in scene [{scene_name}].")

    json_materials = _get(doc, "Materials", list, scene_name)
    json_objects = _get(doc, "Objects", list, scene_name)
    json_camera = _get(doc, "Camera", dict, scene_name)

    # Camera (scene.c:124-147)
    _err(len(json_camera) == 5,
         "Expected token [Camera] to contain 5 elements.")
    camera = {
        "position": _get_arr(json_camera, "position", 3, scene_name),
        "vector_x": _get_arr(json_camera, "vector_x", 3, scene_name),
        "vector_y": _get_arr(json_camera, "vector_y", 3, scene_name),
        "fov": _get_num(json_camera, "fov", scene_name),
        "focal_length": _get_num(json_camera, "focal_length", scene_name),
    }

    # Materials (scene.c:149-193); ids are arbitrary ints resolved by search
    _err(len(json_materials) > 0,
         f"Expected token [Materials] to contain nonzero element count in scene [{scene_name}].")
    materials = []
    id_to_index: dict[int, int] = {}
    for i, jm in enumerate(json_materials):
        _err(isinstance(jm, dict),
             f"Expected token in [Materials] of type Object in scene [{scene_name}].")
        mat = {
            "ks": _get_arr(jm, "ks", 3, scene_name),
            "ka": _get_arr(jm, "ka", 3, scene_name),
            "kr": _get_arr(jm, "kr", 3, scene_name),
            "kt": _get_arr(jm, "kt", 3, scene_name),
            "ke": _get_arr(jm, "ke", 3, scene_name),
            "shininess": float(_get_num(jm, "shininess", scene_name)),
            "refractive_index": float(
                _get_num(jm, "refractive_index", scene_name)),
        }
        mat.update(_texture_load(_get(jm, "texture", dict, scene_name),
                                 scene_name))
        mid = int(_get_num(jm, "id", scene_name))
        # first-match wins, like the linear search (material.c:94-102)
        id_to_index.setdefault(mid, i)
        materials.append(mat)

    def material_index(mid: int) -> int:
        if mid not in id_to_index:
            raise SceneError(f"Failed to get material id [{mid}].")
        return id_to_index[mid]

    # Objects (scene.c:295-361)
    _err(len(json_objects) > 0,
         f"Expected token [Objects] to contain nonzero element count in scene [{scene_name}].")

    sphere_center, sphere_radius, sphere_mat, sphere_eps, sphere_lights = \
        [], [], [], [], []
    tri_vertices, tri_mat, tri_eps, tri_lights = [], [], [], []
    plane_point, plane_normal, plane_mat, plane_eps = [], [], [], []

    def common(params):
        eps = params.get("epsilon")
        eps = float(eps) if isinstance(eps, (int, float)) \
            and not isinstance(eps, bool) else -1.0
        nl = params.get("lights")
        nl = int(nl) if isinstance(nl, (int, float)) \
            and not isinstance(nl, bool) else 0
        mi = material_index(int(_get_num(params, "material", scene_name)))
        return mi, eps, nl

    for jo in json_objects:
        _err(isinstance(jo, dict),
             f"Expected token in [Objects] of type Object in scene [{scene_name}].")
        otype = _get(jo, "type", str, scene_name)
        params = _get(jo, "parameters", dict, scene_name)
        mi, eps, nl = common(params)
        if otype == "Sphere":
            sphere_center.append(_get_arr(params, "position", 3, scene_name))
            sphere_radius.append(float(_get_num(params, "radius", scene_name)))
            sphere_mat.append(mi)
            sphere_eps.append(eps)
            sphere_lights.append(nl)
        elif otype == "Triangle":
            tri_vertices.append([
                _get_arr(params, "vertex_1", 3, scene_name),
                _get_arr(params, "vertex_2", 3, scene_name),
                _get_arr(params, "vertex_3", 3, scene_name),
            ])
            tri_mat.append(mi)
            tri_eps.append(eps)
            tri_lights.append(nl)
        elif otype == "Plane":
            plane_point.append(_get_arr(params, "position", 3, scene_name))
            plane_normal.append(_get_arr(params, "normal", 3, scene_name))
            plane_mat.append(mi)
            plane_eps.append(eps)
            # planes cannot be emittant (object.c:452)
            mat_ke = materials[mi]["ke"]
            _err(float(np.linalg.norm(mat_ke)) <= 1e-6,
                 "Plane cannot be emittant")
        elif otype == "Mesh":
            fname = _get(params, "filename", str, scene_name)
            pos = _get_arr(params, "position", 3, scene_name)
            rot = _get_arr(params, "rotation", 3, scene_name)
            msc = float(_get_num(params, "scale", scene_name))
            if mesh_root is not None and not os.path.isabs(fname) \
                    and os.path.exists(os.path.join(mesh_root, fname)):
                fname = os.path.join(mesh_root, fname)
            elif not os.path.isabs(fname) and not os.path.exists(fname):
                # reference semantics are CWD-relative (object.c:523 fopen);
                # fall back to the scene file's repo root (scenes/ sibling),
                # then to the substitute-mesh dir (assets/meshes holds
                # generated stand-ins for the dragon/menger STLs missing
                # from the reference mount — tools/gen_meshes.py)
                alt = os.path.join(
                    os.path.dirname(os.path.dirname(os.path.abspath(path))),
                    fname)
                sub = os.path.join(
                    os.environ.get(
                        "CRT_MESH_SUBSTITUTES",
                        os.path.join(os.path.dirname(os.path.dirname(
                            os.path.dirname(os.path.abspath(__file__)))),
                            "assets", "meshes")),
                    os.path.basename(fname))
                if os.path.exists(alt):
                    fname = alt
                elif os.path.exists(sub):
                    fname = sub
            verts = stl_mod.load_stl(fname, pos, rot, msc)
            tri_vertices.extend(np.asarray(verts, np.float32))
            tri_mat.extend([mi] * len(verts))
            tri_eps.extend([eps] * len(verts))
            tri_lights.extend([nl] * len(verts))
        else:
            raise SceneError(
                f"Unrecognized object type [{otype}] in scene [{scene_name}].")

    ambient = (0.0, 0.0, 0.0)
    ja = doc.get("AmbientLight")
    if isinstance(ja, list) and len(ja) == 3:
        ambient = tuple(float(x) for x in ja)

    scene = T.make_scene(
        sphere_center=sphere_center, sphere_radius=sphere_radius,
        sphere_material=sphere_mat, sphere_epsilon=sphere_eps,
        sphere_lights=sphere_lights,
        tri_vertices=tri_vertices, tri_material=tri_mat,
        tri_epsilon=tri_eps, tri_lights=tri_lights,
        plane_point=plane_point, plane_normal=plane_normal,
        plane_material=plane_mat, plane_epsilon=plane_eps,
        materials=materials, camera=camera, ambient=ambient,
    )

    if len(scene.static.emitter_prims) == 0:
        raise SceneError(
            f"Expected non-zero number of emittant objects in scene [{scene_name}].")

    if scale is not None:
        from c_raytracer_tpu_torch.scene.scale import scene_scale, norm_scale_factor
        factor = norm_scale_factor(scene) if scale == "norm" else float(scale)
        scene = scene_scale(scene, factor)
    return scene

"""The port's postprocessing (c_raytracer_tpu_torch/postprocess/ops.py)
and its postprocess CLI against the JAX package's, on the reference
binary's raw goldens (tests/goldens/scene1_96_raw.tif, scene3_96_raw.tif).

* Each op against JAX's op on the same arrays: equal, NaN where JAX has
  NaN, after subnormal results are read as 0 on both sides (XLA's CPU
  flushes subnormals to zero and torch keeps them; the raw goldens hold
  the reference's uninitialised memory, subnormals included).
* The 8-bit results against the reference binary's goldens
  (tests/goldens/pp_*.tif) under the gates of tests/test_postprocess.py.
* The port's CLI on the CPU against the JAX CLI: byte-equal files for
  ``-b`` and ``--mist``, which JAX runs eagerly; for ``--dof`` and
  ``--dof-camera``, which the JAX CLI jits, at least 0.999 of the pixels
  within 1 of 256 (XLA may contract ``z·scale + bias`` into an FMA and
  move a CoC radius across an integer; on these inputs no pixel moves).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.cli.postprocess import main as jax_main
from c_raytracer_tpu.image import read_tiff as jax_read_tiff
from c_raytracer_tpu.postprocess import ops as J
from c_raytracer_tpu_torch.cli.postprocess import main
from c_raytracer_tpu_torch.image import quantize_rgb8, read_tiff
from c_raytracer_tpu_torch.image import write_tiff_raw, write_tiff_rgb8
from c_raytracer_tpu_torch.postprocess import ops as P

pytest_plugins = ("torch_harness",)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
RAW1 = os.path.join(GOLDEN_DIR, "scene1_96_raw.tif")
RAW3 = os.path.join(GOLDEN_DIR, "scene3_96_raw.tif")
TINY = np.finfo(np.float32).tiny


def _raw(path):
    img, z = read_tiff(path)
    return img, z.reshape(img.shape[:2])


def _flushed(x):
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < TINY, np.float32(0), x)


def _assert_same(ours, theirs):
    a, b = _flushed(ours), _flushed(theirs)
    assert a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True), np.nanmax(np.abs(a - b))


def q8(img):
    return quantize_rgb8(np.asarray(img)).astype(np.int32)


def golden(name):
    img, _ = read_tiff(os.path.join(GOLDEN_DIR, name))
    return (img * 255.0).astype(np.int32)


def _ops(case):
    """(port result, JAX result) of one op case."""
    t = torch.from_numpy
    img, z = _raw(RAW1)
    img3, z3 = _raw(RAW3)
    ji, jz, ji3, jz3 = (jnp.asarray(x) for x in (img, z, img3, z3))
    if case == "brighten":
        return P.brighten(t(img), 2.5), J.brighten(ji, 2.5)
    if case.startswith("mist_"):
        f = case[5:]
        return (P.mist(t(img), t(z), 2.0, 10.0, f, [0.5, 0.6, 0.7]),
                J.mist(ji, jz, 2.0, 10.0, f, [0.5, 0.6, 0.7]))
    if case == "dof_identity":
        return (P.depth_of_field(t(img), t(z), 0.0, 0.0),
                J.depth_of_field(ji, jz, 0.0, 0.0))
    if case == "dof":
        return (P.depth_of_field(P.brighten(t(img), 2.0), t(z), 0.02, -1.0),
                J.depth_of_field(J.brighten(ji, 2.0), jz, 0.02, -1.0))
    if case == "dof_big":
        return (P.depth_of_field(t(img3), t(z3), 1.2, -12.0),
                J.depth_of_field(ji3, jz3, 1.2, -12.0))
    if case == "dof_camera":
        s, b = P.dof_camera_params(t(z3), 0.1, 0.2, 3.0)
        js, jb = J.dof_camera_params(jz3, 0.1, 0.2, 3.0)
        assert (s, b) == (js, jb)
        return (P.depth_of_field(t(img3), t(z3), s, b),
                J.depth_of_field(ji3, jz3, js, jb))
    raise ValueError(case)


OPS = ["brighten", "mist_lin", "mist_quad", "mist_inv_quad", "dof_identity",
       "dof", "dof_big", "dof_camera"]


@pytest.mark.parametrize("case", OPS)
def test_op_equals_jax(case):
    ours, theirs = _ops(case)
    assert ours.dtype == torch.float32
    _assert_same(ours.numpy(), theirs)


def test_dof_identity_and_truncation():
    """scale = bias = 0: radius 0 everywhere, alpha 1, the identity; and a
    ``max_radius`` bound below the true radius changes the result (the
    larger discs are truncated), at or above it does not."""
    img3, z3 = (torch.from_numpy(x) for x in _raw(RAW3))
    fin = torch.isfinite(img3)
    out = P.depth_of_field(img3, z3, 0.0, 0.0)
    assert torch.equal(out[fin], img3[fin])
    full = P.depth_of_field(img3, z3, 1.2, -12.0)
    r = int(P.coc_radius(z3, 1.2, -12.0).max())
    assert r >= 9
    same = P.depth_of_field(img3, z3, 1.2, -12.0, max_radius=r + 2)
    assert torch.equal(torch.isnan(same), torch.isnan(full))
    ok = ~torch.isnan(full)
    assert torch.equal(same[ok], full[ok])
    cut = P.depth_of_field(img3, z3, 1.2, -12.0, max_radius=3)
    assert not torch.equal(torch.nan_to_num(cut), torch.nan_to_num(full))


@pytest.mark.parametrize("case,name", [
    ("brighten", "pp_brighten.tif"), ("mist_lin", "pp_mist.tif"),
    ("dof", "pp_dof.tif"), ("dof_camera", "pp_dof_camera.tif"),
    ("dof_big", "pp_dof_big.tif")])
def test_goldens(case, name):
    """The reference binary's 8-bit outputs, with tests/test_postprocess.py's
    gates: brighten and dof-camera exact; mist 0.999 within 1 (max 2);
    dof 0.995 within 1; the big-radius dof 0.999 within 1 (sums of the raw
    input's ±1e36 garbage flip a 0/255 clamp by summation order)."""
    ours = q8(_ops(case)[0].numpy())
    diff = np.abs(ours - golden(name))
    if case in ("brighten", "dof_camera"):
        np.testing.assert_array_equal(diff, 0)
    elif case == "mist_lin":
        assert (diff <= 1).mean() > 0.999 and diff.max() <= 2
    elif case == "dof":
        assert (diff.max(-1) <= 1).mean() > 0.995
    else:
        assert (diff.max(-1) <= 1).mean() >= 0.999


CLI_CASES = {
    "brighten_mist_inv_quad": (RAW1, ["-b", "2.5", "--mist", "2", "10",
                                      "inv-quad", "0.5", "0.6", "0.7"]),
    "mist_quad": (RAW3, ["--mist", "1", "6", "quad", "0.1", "0.2", "0.3"]),
    "brighten_dof": (RAW1, ["-b", "2", "--dof", "0.02", "-1"]),
    "dof_big_mist": (RAW3, ["--dof", "1.2", "-12", "--mist", "1", "10",
                            "lin", "0.5", "0.6", "0.7"]),
    "dof_camera": (RAW3, ["-b", "1.5", "--dof-camera", "0.1", "0.2", "3.0"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_jax_cli(tmp_path, case):
    raw, flags = CLI_CASES[case]
    ours, theirs = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    assert main([raw, ours, *flags, "--device", "cpu"]) == 0
    assert jax_main([raw, theirs, *flags]) == 0
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        same = f.read() == g.read()
    if "--dof" in flags or "--dof-camera" in flags:
        a, _ = read_tiff(ours)
        b, _ = jax_read_tiff(theirs)
        diff = np.abs(np.round(a * 255) - np.round(b * 255)).max(-1)
        assert (diff <= 1).mean() >= 0.999
    else:
        assert same


def test_cli_rejects_as_jax(tmp_path, capsys):
    """A bad falloff token and a file without the z-buffer: exit 1 with
    the JAX CLI's message."""
    rng = np.random.default_rng(3)
    img = rng.random((4, 4, 3)).astype(np.float32)
    raw, rgb = str(tmp_path / "in.tif"), str(tmp_path / "rgb.tif")
    write_tiff_raw(raw, img, np.ones(16, np.float32))
    write_tiff_rgb8(rgb, img)
    bad = ["--mist", "1", "10", "cubic", "0", "0", "0"]
    for fn, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert fn([raw, str(tmp_path / "o.tif"), *bad, *extra]) == 1
        assert "Unrecognized falloff type [cubic]." in capsys.readouterr().out
        assert fn([rgb, str(tmp_path / "o.tif"), *extra]) == 1
        assert "Failed to read z-buffer" in capsys.readouterr().out

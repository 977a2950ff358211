"""The port's TIFF codec (c_raytracer_tpu_torch/image/tiff.py) against
the JAX package's: the files it writes are byte-equal to JAX's for the
same arrays, its reader returns what JAX's returns (on JAX's files and on
the reference binary's raw goldens), and ``quantize_rgb8`` is JAX's
clamp, NaN and +inf to 255.  Inputs are seeded numpy arrays that hold
NaN, ±inf, ±1e36 and negative values, the garbage the reference's
uninitialised raster leaves in its raw files.
"""

import os

import numpy as np
import pytest

from c_raytracer_tpu.image import tiff as jax_tiff
from c_raytracer_tpu_torch.image import tiff

pytest_plugins = ("torch_harness",)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = (rng.normal(size=(h, w, 3)) * 2).astype(np.float32)
    img.reshape(-1)[rng.choice(img.size, 6, replace=False)] = [
        np.nan, np.inf, -np.inf, 1e36, -1e36, 1e-40]
    z = rng.uniform(0, 20, h * w).astype(np.float32)
    z[rng.choice(z.size, 4, replace=False)] = [0.0, np.inf, 1e36, -1.0]
    return img, z


def _same(a, b):
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("shape", [(13, 17), (2, 3), (64, 48)])
@pytest.mark.parametrize("kind", ["rgb8", "raw"])
def test_files_byte_equal_to_jax(tmp_path, shape, kind):
    img, z = _image(sum(shape), *shape)
    ours, theirs = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    if kind == "rgb8":
        tiff.write_tiff_rgb8(ours, img)
        jax_tiff.write_tiff_rgb8(theirs, img)
    else:
        tiff.write_tiff_raw(ours, img, z)
        jax_tiff.write_tiff_raw(theirs, img, z)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    # the port reads back what it wrote: raw exactly, 8-bit quantized
    back, zb = tiff.read_tiff(ours)
    if kind == "raw":
        assert _same(back, img) and _same(zb, z)
    else:
        assert zb is None
        assert _same(np.round(back * 255).astype(np.uint8),
                     tiff.quantize_rgb8(img))


@pytest.mark.parametrize("name", ["scene1_96_raw.tif", "scene3_96_raw.tif",
                                  "pp_dof.tif", "scene1_128_default.tif"])
def test_reads_goldens_as_jax(name):
    """The reference binary's files (libtiff's layout): equal arrays, NaN
    where JAX has NaN."""
    path = os.path.join(GOLDEN_DIR, name)
    img, z = tiff.read_tiff(path)
    jimg, jz = jax_tiff.read_tiff(path)
    assert img.dtype == jimg.dtype == np.float32
    assert img.shape == jimg.shape and _same(img, jimg)
    assert (z is None) == (jz is None)
    if z is not None:
        assert z.dtype == np.float32 and _same(z, jz)
        z[0] = 1.0                       # a writable array, as JAX's


def test_reads_jax_files(tmp_path):
    img, z = _image(5, 9, 11)
    p = str(tmp_path / "j.tif")
    jax_tiff.write_tiff_raw(p, img, z)
    got, gz = tiff.read_tiff(p)
    want, wz = jax_tiff.read_tiff(p)
    assert _same(got, want) and _same(gz, wz)


def test_quantize_equals_jax():
    img, _ = _image(7, 32, 32)
    q = tiff.quantize_rgb8(img)
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(q, jax_tiff.quantize_rgb8(img))
    special = np.array([np.nan, np.inf, -np.inf, 1e36, -1e36, 0.5, 1.0],
                       np.float32)
    np.testing.assert_array_equal(tiff.quantize_rgb8(special),
                                  [255, 255, 0, 255, 0, 127, 255])


def test_rejects_what_the_reference_rejects(tmp_path):
    p = str(tmp_path / "x.tif")
    with open(p, "wb") as f:
        f.write(b"PK\x03\x04" + b"\x00" * 16)
    with pytest.raises(ValueError, match="Not a TIFF"):
        tiff.read_tiff(p)

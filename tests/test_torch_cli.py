"""The port's engine CLI (c_raytracer_tpu_torch/cli/engine.py) on the CPU
(``--device cpu``; the default device is the card, with no fallback).

* What it writes: the 8-bit file is byte-equal to the port's writer of
  ``make_renderer``'s frame under ``PhiloxSampler(seed)``, and the raw
  file (``-f``) holds that frame's image and z bit for bit.
* The always-on runtime truncation guard of tests/test_cli.py on the
  port: a starved budget warns on a plain invocation and on the
  progressive path, an exhaustive one is silent; an invalid
  ``--shadow-mode`` is an error.  The scene is the same transparent
  triangle soup, built here as a reference-schema JSON file.
* ``--chunks 2 --checkpoint`` writes the checkpoint and its sidecar and
  resumes from them; ``--accel-report`` and ``--accel-tune`` log the
  report and the tuned budgets.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.cli import engine
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.image import read_tiff, write_tiff_rgb8
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import load_scene

pytest_plugins = ("torch_harness",)

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                     "spheres_opaque.json")


def _soup_scene_json(path: str, nt: int = 600) -> str:
    """A transparent triangle soup + emitter + floor as a reference-schema
    scene file (the scene of tests/test_cli.py)."""
    rng = np.random.default_rng(0)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)

    def mat(mid, **kw):
        m = dict(id=mid, ks=[0.0] * 3, ka=[0.0] * 3, kr=[0.0] * 3,
                 kt=[0.0] * 3, ke=[0.0] * 3, shininess=1.0,
                 refractive_index=1.0,
                 texture=dict(type="uniform", color=[1.0, 1.0, 1.0]))
        m.update(kw)
        return m

    objects = [
        dict(type="Sphere", parameters=dict(
            material=2, position=[0.0, 6.0, -2.0], radius=1.0, lights=4)),
        dict(type="Plane", parameters=dict(
            material=0, position=[0.0, -4.0, 0.0], normal=[0.0, 1.0, 0.0])),
    ]
    for t in tv:
        objects.append(dict(type="Triangle", parameters=dict(
            material=1, vertex_1=[float(x) for x in t[0]],
            vertex_2=[float(x) for x in t[1]],
            vertex_3=[float(x) for x in t[2]])))
    scene = dict(
        AmbientLight=[0.3, 0.3, 0.3],
        Camera=dict(position=[0.0, 0.0, -8.0], vector_x=[1.0, 0.0, 0.0],
                    vector_y=[0.0, 1.0, 0.0], fov=60, focal_length=1.0),
        Materials=[
            mat(0, ks=[1.0] * 3, ka=[0.1] * 3),
            mat(1, ks=[1.0] * 3, ka=[0.2] * 3, kt=[0.5, 0.6, 0.7]),
            mat(2, ke=[4.0] * 3),
        ],
        Objects=objects,
    )
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


@pytest.fixture(scope="module")
def soup_json(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return _soup_scene_json(os.path.join(d, "soup.json"))


def _run(capsys, *args):
    rc = engine.main([str(a) for a in args] + ["--device", "cpu"])
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("raw", [False, True])
def test_writes_the_frame(tmp_path, capsys, raw):
    out = tmp_path / "out.tif"
    rc, err = _run(capsys, SCENE, out, 16, 12, "-b", "3", "--seed", "5",
                   *(["-f", "--stats"] if raw else []))
    assert rc == 0 and "Terminating." in err
    sc = load_scene(SCENE)
    img, z = make_renderer(sc.static, RenderConfig(max_bounces=3), 16, 12,
                           device="cpu")(sc.params, PhiloxSampler(5, "cpu"))
    got, gz = read_tiff(str(out))
    if raw:
        assert "Shadow sweep exhaustive (spill 0)." in err
        assert "rays/s" in err
        np.testing.assert_array_equal(got, img.numpy())
        np.testing.assert_array_equal(gz, z.numpy().reshape(-1))
    else:
        assert gz is None
        want = tmp_path / "want.tif"
        write_tiff_rgb8(str(want), img.numpy())
        assert out.read_bytes() == want.read_bytes()


def test_plain_invocation_warns_on_starved_budget(soup_json, tmp_path,
                                                   capsys):
    """No --stats: the guard must still warn (always on)."""
    out = tmp_path / "out.tif"
    rc, err = _run(capsys, soup_json, out, 8, 8, "-b", "2",
                   "--shadow-visits", "1", "--visits", "1")
    assert rc == 0
    assert "WARNING: shadow visit budget EXCEEDED" in err
    assert "WARNING: closest-hit visit budget EXCEEDED" in err
    assert out.exists()


def test_plain_invocation_silent_when_exhaustive(soup_json, tmp_path,
                                                 capsys):
    rc, err = _run(capsys, soup_json, tmp_path / "out2.tif", 8, 8, "-b", "2")
    assert rc == 0
    assert "WARNING" not in err


def test_progressive_path_warns(soup_json, tmp_path, capsys):
    """--chunks goes through render_progressive: the same guard."""
    rc, err = _run(capsys, soup_json, tmp_path / "out3.tif", 8, 8, "-b", "2",
                   "--chunks", "2", "--shadow-visits", "1")
    assert rc == 0
    assert "WARNING: shadow visit budget exceeded" in err


def test_invalid_shadow_mode_errors(soup_json, tmp_path, capsys):
    rc = engine.main([soup_json, str(tmp_path / "x.tif"), "4", "4",
                      "--shadow-mode", "per-ray", "--device", "cpu"])
    assert rc == 1
    assert "Invalid --shadow-mode" in capsys.readouterr().out


def test_valid_shadow_mode_accepted(soup_json, tmp_path, capsys):
    rc, _ = _run(capsys, soup_json, tmp_path / "y.tif", 4, 4, "-b", "1",
                 "--shadow-mode", "union")
    assert rc == 0


def test_checkpointed_chunks_resume(tmp_path, capsys):
    out, ck = tmp_path / "out.tif", tmp_path / "ck.tif"
    args = (SCENE, out, 8, 8, "-b", "2", "--chunks", "2", "--checkpoint", ck,
            "-f")
    rc, err = _run(capsys, *args)
    assert rc == 0 and "Progressive chunk 2/2 done." in err
    with open(str(ck) + ".progress.json") as f:
        assert json.load(f)["done"] == 2
    first, z = read_tiff(str(out))
    np.testing.assert_array_equal(read_tiff(str(ck))[0], first)
    # the sidecar says every chunk is done: nothing left to render
    rc, err = _run(capsys, *args)
    assert rc == 0 and "Resuming progressive render at chunk 2/2." in err
    assert "Progressive chunk" not in err
    again, z2 = read_tiff(str(out))
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(z2, z)


def test_accel_report_and_tune_log(soup_json, tmp_path, capsys):
    rc, err = _run(capsys, soup_json, tmp_path / "r.tif", 8, 8, "-b", "1",
                   "--accel-report")
    assert rc == 0 and "Accel spill report: {'accel': 'cluster'" in err
    rc, err = _run(capsys, soup_json, tmp_path / "t.tif", 8, 8, "-b", "1",
                   "--visits", "2", "--accel-tune", "--stats")
    assert rc == 0
    tune = re.findall(r"Accel auto-tune: visits=(\d+) shadow_visits=(\d+) "
                      r"shortlist=0\.", err)
    assert len(tune) == 1 and "Accel spill report:" in err
    # 2 x the measured primary overlap, in multiples of 8, above --visits
    v, sv = (int(x) for x in tune[0])
    assert v > 2 and v % 8 == 0 and sv >= v


def test_usage_and_no_fallback(tmp_path, capsys):
    assert engine.main(["--help"]) == 0
    assert "--device" in capsys.readouterr().out
    assert engine.main([SCENE, "x.tif", "4"]) == 1
    assert "Too few arguments" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the default device is the card: no CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            engine.main([SCENE, str(tmp_path / "z.tif"), "4", "4"])
        assert not (tmp_path / "z.tif").exists()

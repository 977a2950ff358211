"""The plain reference against the program on the CPU at 16×16, for both
configurations and one gradient step; and the reference alone."""

import json
import os

import pytest
import torch

from benchmark import check, core, renderer
from benchmark import reference as R
from conftest import ROOT, tiny_root


def cell(name, tmp_path, res):
    tiny_root(str(tmp_path), {name: res})
    return core.cell_of(core.load_spec(str(tmp_path)), name, False,
                        str(tmp_path))


def program_frame(c, seed):
    return renderer.Program(c, "cpu").frame(seed)


@pytest.mark.parametrize("name,res", [("spheres1024.frame", 16),
                                      ("spheres1024.gi4", 16),
                                      ("glass32.frame", 16)])
def test_frame_matches_the_program(name, res, tmp_path):
    c = cell(name, tmp_path, res)
    seed = core.iter_seed(2 ** 31 + 5, 1)
    img, z = program_frame(c, seed)
    r_img, r_z = renderer.reference_frame(c, seed, "cpu", torch.float32)
    assert check.frame_numbers(img, z, r_img, r_z)["off_share"] == 0.0
    assert float(r_img.abs().sum()) > 0 and float(r_z.abs().sum()) > 0
    assert torch.allclose(img, r_img, rtol=1e-5, atol=1e-7)


def test_step_gradients_match_the_program(tmp_path):
    c = cell("spheres512.step", tmp_path, 16)
    seed = 2 ** 31 + 9
    run = c.runner.Runner(c, seed, "cpu", {})
    run.setup()
    got = check.step_numbers(run.record(), c.runner.reference_steps(
        c, seed, "cpu", torch.float32))
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-5
    # the steps moved the colours
    assert all(float(v.norm()) > 0 for v in run.record()["change"].values())


def test_reference_reads_the_mesh_it_names(tmp_path):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "meshes_glass.json")) as f:
        doc = json.load(f)
    doc["mesh_sha256"]["assets/meshes/dragon.stl"] = "0" * 64
    path = tmp_path / "glass.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="not the mesh"):
        R.load(str(path), root=ROOT)


def test_draws_are_the_tile_arrays():
    """A lane's draws are the lane's column of the whole tile's array."""
    lanes = torch.tensor([0, 5, 63])
    got = R.tile_draw(77, (1, 2, 0, 3), 6, 64, lanes)
    full = R.uniform_at(77, (1, 2, 0, 3), torch.arange(6 * 64)).reshape(
        6, 64)
    assert torch.equal(got, full[:, lanes])
    assert float(full.min()) >= 0 and float(full.max()) < 1

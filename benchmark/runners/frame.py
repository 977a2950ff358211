"""Frames back to back through the port's ``make_renderer``
(``renderer.Program``): each iteration one ``render_fn`` call, its draws
from ``PhiloxSampler(iter_seed(seed, i))``, ending in a synchronize.  The
check keeps ``check.frames`` of the window's frames, every
``check.stride``-th from its first, copied to the host after the frame
(or, traced, after the profiler), and compares each with the reference's
frame under the same draws."""

from __future__ import annotations

import torch

from benchmark import check, core, renderer

ITERATION = "frame"
FIRST = 1           # iteration 0 is the warm-up


class Runner:
    def __init__(self, cell, seed, device, hooks):
        self.cell, self.seed, self.hooks = cell, seed, hooks
        self.prog = renderer.Program(cell, device)
        c = cell.traffic["check"]
        self.stride, self.n_keep = int(c["stride"]), int(c["frames"])
        self.i, self.kept, self.pending, self.spans = 0, {}, [], {}

    def setup(self):
        self.iteration(timed=False)     # the warm-up, iteration 0
        self.pending = []

    def _frame(self, i):
        with torch.profiler.record_function("bench.frame"):
            img, z = self.prog.frame(core.iter_seed(self.seed, i))
        if "output" in self.hooks:
            img, z = self.hooks["output"](img, z)
        return img, z

    def iteration(self, timed):
        i = self.i
        img, z = self._frame(i)
        if (i >= FIRST and (i - FIRST) % self.stride == 0
                and len(self.kept) + len(self.pending) < self.n_keep):
            self.pending.append((i, img, z))
        self.i += 1

    def sync(self):
        self.prog.sync()

    def after(self):
        for i, img, z in self.pending:
            self.kept[i] = (img.detach().cpu(), z.detach().cpu())
        self.pending = []

    def replay(self, indices):
        """The frames of ``indices`` again, under the same draws, for the
        readers' captures; nothing is kept."""
        for i in indices:
            self._frame(i)
            self.sync()

    def record(self):
        return {"frames": self.kept}


def checked(cell) -> list:
    """The iterations whose frames a run keeps for the check."""
    c = cell.traffic["check"]
    return [FIRST + k * int(c["stride"]) for k in range(int(c["frames"]))]


def _worst(pairs) -> dict:
    worst: dict = {}
    for got in pairs:
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def reference_numbers(cell, record, seed, device) -> dict:
    """The check's numbers: the worst over the kept frames."""
    def each():
        for i, (img, z) in record["frames"].items():
            r_img, r_z = renderer.reference_frame(
                cell, core.iter_seed(seed, i), device, torch.float32)
            yield check.frame_numbers(img, z, r_img.cpu(), r_z.cpu())
    return _worst(each())


def program_numbers(cell, seed, device, hooks=None) -> dict:
    """The numbers a run on ``seed`` reads, from the frames it keeps,
    rendered alone (no window)."""
    run = Runner(cell, seed, device, hooks or {})
    for i in checked(cell):
        img, z = run._frame(i)
        run.kept[i] = (img.cpu(), z.cpu())
    record = run.record()
    del run
    return reference_numbers(cell, record, seed, device)


def control_numbers(cell, seed, device) -> dict:
    """The reference in bfloat16 in the program's place."""
    def each():
        for i in checked(cell):
            s = core.iter_seed(seed, i)
            img, z = renderer.reference_frame(cell, s, device,
                                              torch.bfloat16)
            r_img, r_z = renderer.reference_frame(cell, s, device,
                                                  torch.float32)
            yield check.frame_numbers(img.float().cpu(), z.float().cpu(),
                                      r_img.cpu(), r_z.cpu())
    return _worst(each())


def halve(img, z):
    """Every other pixel of a frame left out."""
    h, w = z.shape
    keep = (torch.arange(h * w, device=z.device) % 2 == 0).reshape(h, w)
    return (torch.where(keep[..., None], img, 0.0),
            torch.where(keep, z, 0.0))


HALF_HOOKS = {"output": halve}

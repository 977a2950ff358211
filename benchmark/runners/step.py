"""Gradient steps back to back through the port's ``make_renderer``
(``renderer.Program``): a frame, mean((img − target)²), ``backward()`` to
every leaf, and plain SGD on the traffic's ``update`` leaves at rate
``lr``.  Set-up renders the target from the leaves perturbed by the seed
and takes the first three steps through the window's own call; the check
follows those three with the reference.  The window's losses are printed
beside the check (they are not compared: they have no reference)."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import check, core, renderer

ITERATION = "step"
CHECKED_STEPS = 3


def perturbed(leaves: dict, names, seed: int, spread: float) -> dict:
    """Copies of ``leaves`` (tensors or arrays) with each entry of the
    ``names`` leaves scaled by a factor drawn uniformly from [1 − spread,
    1 + spread] by a NumPy generator seeded with ``seed``."""
    import numpy as np
    g = np.random.default_rng(int(seed))
    out = dict(leaves)
    for k in names:
        v = leaves[k]
        f = g.uniform(1 - spread, 1 + spread, size=tuple(v.shape))
        if hasattr(v, "detach"):
            out[k] = v.detach() * v.new_tensor(f.astype("float32"))
        else:
            out[k] = (v * f).astype(v.dtype)
    return out


def replace_leaves(params, leaves: dict):
    """``params`` (the program's SceneParams) with the named leaves
    replaced."""
    mats = {k.split(".", 1)[1]: v for k, v in leaves.items()
            if k.startswith("materials.")}
    cam = {k.split(".", 1)[1]: v for k, v in leaves.items()
           if k.startswith("camera.")}
    top = {k: v for k, v in leaves.items() if "." not in k}
    return dataclasses.replace(
        params, materials=dataclasses.replace(params.materials, **mats),
        camera=dataclasses.replace(params.camera, **cam), **top)


class Runner:
    def __init__(self, cell, seed, device, hooks):
        self.cell, self.seed, self.hooks = cell, seed, hooks
        self.prog = renderer.Program(cell, device)
        tr = cell.traffic
        self.names, self.lr = list(tr["update"]), float(tr["lr"])
        self.i, self.spans = 0, {"backward": []}
        self.trace_bwd = False
        self.pending, self.window_losses = [], []

    def setup(self):
        tr = self.cell.traffic
        p = self.prog
        pert = perturbed(p.leaves, tr["perturb"], self.seed, tr["spread"])
        with torch.no_grad():
            self.target = p.frame(core.iter_seed(self.seed, "target"),
                                  replace_leaves(p.params, pert))[0]
        for x in p.leaves.values():
            x.requires_grad_(True)
        self.p0 = {k: p.leaves[k].detach().clone() for k in self.names}
        self.losses = []
        for k in range(CHECKED_STEPS):
            loss = self._step()
            self.losses.append(float(loss))
            if k == 0:
                self.grad1 = {n: (x.grad.detach().clone() if x.grad is not None
                                  else torch.zeros_like(x))
                              for n, x in p.leaves.items()}
        self.change = {k: p.leaves[k].detach() - self.p0[k]
                       for k in self.names}

    def _forward_backward(self, i):
        p = self.prog
        for x in p.leaves.values():
            x.grad = None
        with torch.profiler.record_function("bench.forward"):
            img, _ = p.frame(core.iter_seed(self.seed, i))
        if "output" in self.hooks:
            img, _ = self.hooks["output"](img, _)
        with torch.profiler.record_function("bench.loss"):
            if "loss" in self.hooks:
                loss = self.hooks["loss"](img, self.target)
            else:
                loss = ((img - self.target) ** 2).mean()
        a = time.perf_counter()
        with torch.profiler.record_function("bench.backward"):
            loss.backward()
        if self.trace_bwd:
            p.sync()
            self.spans["backward"].append(time.perf_counter() - a)
        return loss.detach()

    def _step(self):
        p = self.prog
        loss = self._forward_backward(self.i)
        with torch.profiler.record_function("bench.update"):
            if "update" in self.hooks:
                self.hooks["update"](p.leaves, self.names, self.lr)
            else:
                with torch.no_grad():
                    for k in self.names:
                        p.leaves[k] -= self.lr * p.leaves[k].grad
        self.i += 1
        return loss

    def iteration(self, timed):
        self.trace_bwd = not timed
        self.pending.append(self._step())

    def sync(self):
        self.prog.sync()

    def after(self):
        self.window_losses += [float(x) for x in self.pending]
        self.pending = []

    def replay(self, indices):
        """The forward and backward of the steps of ``indices`` again,
        under the same draws and without the update, for the readers'
        captures (the update moves colours only, so every call's shape
        and live lanes are the window's)."""
        self.trace_bwd = False
        for i in indices:
            self._forward_backward(i)
            self.sync()
        for x in self.prog.leaves.values():
            x.grad = None

    def record(self):
        return {"losses": self.losses,
                "grad1": {k: v.cpu() for k, v in self.grad1.items()},
                "change": {k: v.cpu() for k, v in self.change.items()},
                "window_losses": self.window_losses}


def notes(record) -> list:
    """The window's losses, for standard error."""
    w = record["window_losses"]
    if not w:
        return []
    finite = all(x == x and abs(x) != float("inf") for x in w)
    return [f"window losses ({len(w)} steps, all finite: {finite}): "
            f"first {w[0]!r}, last {w[-1]!r}, last/first "
            f"{w[-1] / w[0] if w[0] else float('nan')!r}"]


def reference_steps(cell, seed: int, device, dtype,
                    shade_dtype=None) -> dict:
    """The reference's first three steps from the configuration's leaves,
    its own target, the same draws."""
    from benchmark import reference
    tr = cell.traffic
    scene = reference.load(cell.config_path, root=renderer.root_of(cell))
    flags = renderer.reference_flags(cell)
    res = int(tr["resolution"])
    leaves = reference.device_leaves(scene, device, dtype)
    pert = perturbed(leaves, tr["perturb"], seed, tr["spread"])
    kw = dict(device=device, dtype=dtype, shade_dtype=shade_dtype)
    with torch.no_grad():
        target = reference.render(scene, pert, flags, res, res,
                                  core.iter_seed(seed, "target"), **kw)[0]
    names, lr = list(tr["update"]), float(tr["lr"])
    p0 = {k: leaves[k].clone() for k in names}
    losses = []
    for k in range(CHECKED_STEPS):
        loss, grads = reference.loss_and_grads(
            scene, leaves, flags, res, core.iter_seed(seed, k), target, **kw)
        losses.append(loss)
        if k == 0:
            grad1 = {n: g.float().cpu() for n, g in grads.items()}
        for n in names:
            leaves[n] = leaves[n] - lr * grads[n]
    return {"losses": losses, "grad1": grad1,
            "change": {k: (leaves[k] - p0[k]).float().cpu()
                       for k in names}}


def reference_numbers(cell, record, seed, device) -> dict:
    return check.step_numbers(record, reference_steps(
        cell, seed, device, torch.float32))


def program_numbers(cell, seed, device, hooks=None) -> dict:
    """The numbers a run on ``seed`` reads: its set-up's three steps."""
    run = Runner(cell, seed, device, hooks or {})
    run.setup()
    record = run.record()
    del run
    return reference_numbers(cell, record, seed, device)


def control_numbers(cell, seed, device) -> dict:
    """The reference with its shading in bfloat16 (geometry, occlusion and
    the sums of colour in float32) in the program's place.  All in
    bfloat16, the specular power of non-unit vectors overflows and every
    loss is not a number, which sets no upper reading."""
    low = reference_steps(cell, seed, device, torch.float32,
                          shade_dtype=torch.bfloat16)
    return check.step_numbers(low, reference_steps(cell, seed, device,
                                                   torch.float32))


def half_loss(img, target):
    """The mean over every other pixel only."""
    return ((img - target) ** 2).reshape(-1, 3)[::2].mean()


HALF_HOOKS = {"loss": half_loss}

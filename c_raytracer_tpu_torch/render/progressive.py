"""Progressive rendering with checkpoint/resume, and spp-chunked path-GI
renders, as in ``c_raytracer_tpu.render.progressive``.

The reference's only persisted intermediate is the raw float32 TIFF handoff
between renderer and postprocessor (image.c:64-85, tag 65000).  A
progressive render extends it into a checkpoint: Monte-Carlo samples are
rendered in chunks, the running mean raster and the z-buffer are saved as
that raw TIFF after every chunk, beside a JSON sidecar with the resume
state, and an interrupted render resumes from the first chunk it had not
finished.  Chunk ``c`` renders under ``sampler.fold_in(c)``, so its draws
do not depend on where the render stopped; a resumed render differs from
an uninterrupted one only by the float32 rounding of the saved mean.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from c_raytracer_tpu_torch.core import rng
from c_raytracer_tpu_torch.image import read_tiff, write_tiff_raw
from c_raytracer_tpu_torch.render.api import (make_host_tiled_renderer,
                                              make_renderer)
from c_raytracer_tpu_torch.render.config import RenderConfig


def _sidecar(path: str) -> str:
    return path + ".progress.json"


def render_progressive(scene, cfg: RenderConfig, resx: int, resy: int,
                       sampler=None, *, device, chunks: int = 4,
                       checkpoint: str | None = None, resume: bool = True,
                       log=None, _stop_after: int | None = None):
    """Render in ``chunks`` equal sample chunks on ``device``, optionally
    checkpointed.  Returns (image, z) as float32 numpy arrays.

    Each chunk is an independent render under ``sampler.fold_in(c)``
    (``sampler`` defaults to ``PhiloxSampler(0, device)``; it needs a
    ``seed`` and a ``fold_in``), and the result is their mean, summed in
    float64 on the host.  With ``checkpoint`` set, the running mean is
    written after every chunk, and a sidecar with the same chunks,
    resolution and base seed makes ``resume=True`` continue from the first
    unrendered chunk.  ``_stop_after`` stops after that many chunks (a
    simulated interruption).  The runtime truncation guard stays on:
    ``log`` gets a warning for every chunk whose spill maxima are not 0.
    """
    if sampler is None:
        sampler = rng.PhiloxSampler(0, device)
    fn = make_renderer(scene.static, cfg, resx, resy, device=device,
                       with_stats=True)

    start = 0
    acc = np.zeros((resy, resx, 3), np.float64)
    z = np.zeros((resy, resx), np.float32)
    state = {
        "chunks": chunks, "resx": resx, "resy": resy,
        "base_seed": int(sampler.seed), "done": 0,
    }

    if checkpoint and resume and os.path.exists(_sidecar(checkpoint)):
        with open(_sidecar(checkpoint)) as f:
            saved = json.load(f)
        compat = all(saved.get(k) == state[k]
                     for k in ("chunks", "resx", "resy", "base_seed"))
        if compat and 0 < saved["done"] <= chunks:
            img, zflat = read_tiff(checkpoint)
            z = zflat.reshape(resy, resx)
            start = saved["done"]
            acc = img.astype(np.float64) * start
            if log:
                log("Resuming progressive render at chunk %d/%d.",
                    start, chunks)

    stop = chunks if _stop_after is None else min(_stop_after, chunks)
    for c in range(start, stop):
        img_c, z_c, stats = fn(scene.params, sampler.fold_in(c))
        if log:
            for k, msg in (("shadow_spill_max", "shadow"),
                           ("visit_spill_max", "closest-hit")):
                if float(stats.get(k, 0.0)) > 0:
                    log("WARNING: %s visit budget exceeded by %.0f "
                        "clusters (chunk %d) — raise the budgets or use "
                        "--accel-tune.", msg, float(stats[k]), c)
        acc += img_c.cpu().numpy().astype(np.float64)
        if c == 0:
            z = z_c.cpu().numpy()
        if checkpoint:
            mean = (acc / (c + 1)).astype(np.float32)
            write_tiff_raw(checkpoint, mean, z)
            state["done"] = c + 1
            with open(_sidecar(checkpoint), "w") as f:
                json.dump(state, f)
        if log:
            log("Progressive chunk %d/%d done.", c + 1, chunks)

    return (acc / max(stop, 1)).astype(np.float32), z


def render_spp_chunked(scene, cfg: RenderConfig, resx: int, resy: int,
                       sampler=None, *, device, spp_chunks: int,
                       host_tiled: bool = True, tiles_per_call: int = 1,
                       with_stats: bool = False, log=None):
    """Path-traced render in ``spp_chunks`` passes of ``spp/spp_chunks``
    GI samples each, composed by a host mean that equals the single-call
    render at the full ``cfg.samples_per_pixel`` up to float summation
    order.

    Every pass draws from the same ``sampler`` (default
    ``PhiloxSampler(0, device)``), so the sample-independent parts of the
    frame (primary hits, direct light, emission, z) are bit-identical in
    every pass and survive the mean; pass ``c`` takes the GI samples
    ``c·s .. c·s + s - 1`` (``gi_sample_offset``) pre-weighted by
    ``spp_chunks`` (``gi_chunk_weight``), so the passes partition the
    single call's samples and the mean weighs each 1/spp.

    ``host_tiled``: each pass through ``make_host_tiled_renderer``
    (``tiles_per_call`` tiles at a time), else through ``make_renderer``.
    Returns (image, z) as float32 numpy arrays and, with ``with_stats``,
    the passes' stats: counts summed, ``*_spill_max`` the max.
    """
    if sampler is None:
        sampler = rng.PhiloxSampler(0, device)
    total = cfg.samples_per_pixel
    if total % spp_chunks:
        raise ValueError(
            f"samples_per_pixel={total} not divisible by "
            f"spp_chunks={spp_chunks}")
    s = total // spp_chunks

    acc = np.zeros((resy, resx, 3), np.float64)
    z = None
    stats = {}
    for c in range(spp_chunks):
        ccfg = dataclasses.replace(
            cfg, samples_per_pixel=s, gi_sample_offset=c * s,
            gi_chunk_weight=spp_chunks)
        if host_tiled:
            fn = make_host_tiled_renderer(
                scene.static, ccfg, resx, resy, device=device,
                tiles_per_call=tiles_per_call, with_stats=with_stats)
        else:
            fn = make_renderer(scene.static, ccfg, resx, resy, device=device,
                               with_stats=with_stats)
        out = fn(scene.params, sampler)
        acc += out[0].cpu().numpy().astype(np.float64)
        if c == 0:
            z = out[1].cpu().numpy()
        if with_stats:
            for k, v in out[2].items():
                v = float(v)
                stats[k] = (max(stats.get(k, 0.0), v)
                            if k.endswith("_spill_max")
                            else stats.get(k, 0.0) + v)
        if log:
            log("spp chunk %d/%d done (%d samples).", c + 1, spp_chunks, s)

    img = (acc / spp_chunks).astype(np.float32)
    if with_stats:
        return img, z, stats
    return img, z

"""The port's counterparts of the JAX package's tools under ``tools/``.

Each runs as ``python -m c_raytracer_tpu_torch.tools.<name>``, on the card
unless ``--device cpu`` is given, and prints the JSON lines of its JAX
counterpart under the same keys:

* ``flagship_s5`` — the BASELINE flagship (scene5-class glass mesh, path
  GI at 256 spp, a descent on the glass ``kt``), on the in-repo stand-in
  ``scenes/meshes_glass.json``;
* ``bench_scaling`` — frame seconds and memory against the rank count of
  a ``px`` mesh (``parallel/``);
* ``roofline`` — measured ceilings (device-memory stream, f32 FMA, sinf,
  powf and division chains, a random row gather), one CUDA kernel each
  (``csrc/roofline.cu``).

The four scene5 diagnostics of ``tools/profiling/`` print the JAX
scripts' text lines under their labels, in their order and formats, on the
glass stand-in (``--scene`` changes the scene; ``s5_common`` holds what
they share), and on stderr the kernels' launch counts:

* ``s5_union_bench [res] [max_lights] [configs]`` (64 100): frame
  seconds and total radiance of the union shadow route at shadow
  clusters of "128" (the JAX label; it resolves to 64), 64 and 32 against
  ``per_ray``, each frame's max |Δ| against the first config's;
* ``s5_union_stats [res] [lc]`` (64 40): per-segment cluster overlap and
  per-pixel union size of one light chunk at cluster sizes 16-128 and
  super groups of 16 and 64;
* ``s5_trunc_sweep [res] [nl]`` (32 4): the cluster frame's error against
  the dense frame at five visit and shadow budgets;
* ``s5_diag [res]`` (32): closest-hit and shadow mismatches of the
  cluster intersector against the dense one, and the spill counts.

Their CPU tests: ``python -m pytest tests/test_torch_tool_s5_*.py -q``.
On the card, e.g. ``python3 -m
c_raytracer_tpu_torch.tools.s5_diag 32``; ``chip_smoke.py`` phase 38 runs
all four at cut sizes.
"""

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
"""

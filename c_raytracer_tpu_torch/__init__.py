"""c_raytracer_tpu_torch — the raytracer on PyTorch and CUDA (NVIDIA Hopper).

A port of ``c_raytracer_tpu`` with the same module paths: the JAX package
is the reference this one is held against.  Plain tensor code is PyTorch;
every kernel that the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel here (``csrc/``), built with nvcc for ``sm_90a`` at first use and
bound with ``ctypes`` (``_native.py``).  Each kernel wrapper keeps a plain
PyTorch version beside it, which is what runs for tensors on the CPU.

This package imports ``torch`` and ``numpy`` and never ``jax``.

Slices ported so far, forward and backward (gradients with respect to
every ``SceneParams`` leaf, each round, light chunk and GI sample
rematerialised): the dense render path (spheres, planes and triangles,
ambient and path-traced GI), the mesh path (triangles through the
Morton-cluster sweep with the visit-order kernel, any visit budget up to
the cluster count, shared-origin, union or per-ray soft shadows, sphere
and triangle emitters), the chain integrator of opaque scenes and the
stack integrator of transparent ones (refraction, the inside-object
re-test, shadows tinted by the kt of transparent blockers), and the entry
points ``make_renderer``, ``make_host_tiled_renderer``,
``make_host_tiled_value_and_grad`` and ``render``.  Around them: the
reference's two programs, ``python -m c_raytracer_tpu_torch.cli.engine``
(8-bit or raw float32 TIFF output, progressive checkpointed renders,
the always-on spill warnings, ``--accel-report`` / ``--accel-tune``) and
``python -m c_raytracer_tpu_torch.cli.postprocess`` (brighten, depth of
field, mist), both on the card by default; the TIFF codec (``image/``),
``render_progressive`` and ``render_spp_chunked``
(``render/progressive.py``), the spill diagnostics and policy
(``accel/traverse.py`` ``spill_counts``, ``shadow_spill_counts``;
``accel/validate.py``) and the postprocessing ops (``postprocess/``).

The JAX package's opt-ins of the cluster sweeps and the backward run too:
the two-level super-cluster visit order (``bvh_super_group``,
``bvh_super_sel``), closest-hit ray compaction (``closest_compact="on"``)
and any ``remat_names`` (``shadow_samples`` and ``shade_terms`` beside
``occlusion``, ``core/remat.py``).

Across ranks of a ``torch.distributed`` group (``parallel/``): pixel tiles
over ``px``, Monte-Carlo samples over ``sp`` and primitive ranges over
``pr`` (``geometry/sharded.py``; in one process the ranges can stack,
``make_renderer(shards=S)``), the training step with gradients summed over
the ranks, ``launch`` to start ranks on one host, and the multichip dry run
(``entry.py``).

Nothing is refused: every entry point and ``RenderConfig`` of the JAX
package runs.
"""

__version__ = "0.1.0"

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
Morton-cluster sweep with the visit-order kernel, shared-origin, union or
per-ray soft shadows, sphere and triangle emitters), the chain integrator
of opaque scenes and the stack integrator of transparent ones (refraction,
the inside-object re-test, shadows tinted by the kt of transparent
blockers), and the entry points ``make_renderer``,
``make_host_tiled_renderer``, ``make_host_tiled_value_and_grad`` and
``render``.  Everything else raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""

__version__ = "0.1.0"

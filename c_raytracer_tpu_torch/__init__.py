"""c_raytracer_tpu_torch — the raytracer on PyTorch and CUDA (NVIDIA Hopper).

A port of ``c_raytracer_tpu`` with the same module paths: the JAX package
is the reference this one is held against.  Plain tensor code is PyTorch;
every kernel that the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel here (``csrc/``), built with nvcc for ``sm_90a`` at first use and
bound with ``ctypes`` (``_native.py``).  Each kernel wrapper keeps a plain
PyTorch version beside it, which is what runs for tensors on the CPU.

This package imports ``torch`` and ``numpy`` and never ``jax``.

Slice ported so far: the dense opaque render path (spheres and planes, a
sphere emitter, chain integrator, ambient GI), forward only.  Everything
else raises ``NotImplementedError`` naming the ROADMAP item that brings it.
"""

__version__ = "0.1.0"

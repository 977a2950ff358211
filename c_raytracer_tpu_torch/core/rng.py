"""Uniform random sampling: Philox4x32-10 on the card (kernel 1), keyed by
a sample path.

The reference draws from libc ``rand()`` raced across OpenMP threads
(system.c:36-39) — irreproducible by design — and the JAX package draws
from threefry on the CPU and the TPU's hardware PRNG on the TPU.  All of
them sample U[0,1); the renderer's estimators are tolerance-gated, so this
port is free to use its own stream, and its bits differ from JAX's by
design.

* ``philox_uniform(key, shape, device=)`` fills a float32 tensor: element
  ``i`` is word ``i % 4`` of the Philox4x32-10 block ``i // 4`` (counter
  = (block lo, block hi, 0, 0), key = the two words ``key``), converted as
  ``(w >> 8) * 2^-24`` like the JAX package's ``hw_uniform``.  On a CUDA
  device it launches ``csrc/philox.cu``; on the CPU it runs the plain
  version ``philox_uniform_reference``, which is bit-exact with the kernel.
* ``PhiloxSampler(seed, device)`` derives the key words of a sample path
  (a tuple of ints following the JAX key chain: tile, round, emitter,
  chunk) with a host-side splitmix64, and draws through ``philox_uniform``.
* ``SampleKey`` carries a sampler and a path through the renderer the way
  a JAX key is threaded: ``fold_in`` appends to the path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.core import tracing

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the int64 tensor ``b`` of 32-bit values.  The product can exceed 2^63,
    so it is built from 16-bit limbs whose partial products fit in int64."""
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words; returns
    the four output words (Random123's philox4x32_10)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def philox_uniform_reference(key, shape, *, device) -> torch.Tensor:
    """Plain PyTorch version of kernel 1, bit-exact with it."""
    n = math.prod(shape)
    block = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(block)
    words = torch.stack(philox4x32_10(block & _M32, block >> 32, zero, zero,
                                      int(key[0]), int(key[1])), dim=1)
    u = (words.reshape(-1)[:n] >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape(shape)


def philox_uniform(key, shape, *, device) -> torch.Tensor:
    """U[0,1) float32 tensor of ``shape`` from the Philox stream of the two
    32-bit words ``key`` — kernel 1 on a CUDA device.

    Replaces the TPU kernels of ``c_raytracer_tpu/core/rng.py`` (``_hw_bits``
    with ``_bits_kernel``, ``_hw_bits_2d`` with its inner ``kernel``).  On
    the H100 it is bound by the 4-byte store per element; each thread
    computes one 4-word block and writes it as one 16-byte store."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type == "cpu":
        return philox_uniform_reference(key, shape, device=out.device)
    if out.device.type != "cuda":
        raise ValueError(f"philox_uniform: unsupported device {out.device}")
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _native.lib().crt_philox_uniform(out.data_ptr(), out.numel(),
                                               k0, k1, stream)
    _native.check(err, "philox_uniform")
    tracing.count("kernel.philox_uniform")
    return out


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def path_key(seed: int, path: tuple) -> tuple[int, int]:
    """Two 32-bit Philox key words for (seed, path), by splitmix64."""
    h = _splitmix64(int(seed) & _M64)
    for p in (len(path),) + tuple(path):
        h = _splitmix64(h ^ (int(p) & _M64))
    return h & _M32, h >> 32


class PhiloxSampler:
    """Uniforms for a sample path from the Philox stream of ``seed``.

    ``fold_in(i)`` derives the sampler of a progressive render's chunk
    ``i``, as the JAX package derives ``fold_in(key, i)``: every path it
    draws carries the prefix ``(i,)`` of chunk indices."""

    def __init__(self, seed: int, device, prefix: tuple = ()):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.prefix = tuple(int(i) for i in prefix)

    def fold_in(self, i: int) -> "PhiloxSampler":
        return PhiloxSampler(self.seed, self.device, self.prefix + (i,))

    def uniform(self, path: tuple, shape) -> torch.Tensor:
        return philox_uniform(path_key(self.seed, self.prefix + tuple(path)),
                              shape, device=self.device)


@dataclasses.dataclass(frozen=True)
class SampleKey:
    """A sampler and the path of ints that names one draw."""

    sampler: Any
    path: tuple = ()

    def fold_in(self, i: int) -> "SampleKey":
        return SampleKey(self.sampler, self.path + (int(i),))

    def uniform(self, shape) -> torch.Tensor:
        return self.sampler.uniform(self.path, shape)

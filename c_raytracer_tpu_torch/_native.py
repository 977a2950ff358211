"""Build and bind the CUDA kernels of ``csrc/``.

At first use, nvcc compiles each ``csrc/*.cu`` into a shared library of its
own for ``sm_90a`` with a plain C interface, which ``ctypes`` loads; the
compilers of all sources run at the same time, so the build waits only for
the longest (5.2 s for three sources on the 8-core host of an H100, against
10.0 s for one nvcc over all of them).  Each library lands in
``_build/`` (listed in ``.gitignore``) under a name that carries a hash of
its source and the flags, so an edited source rebuilds.  Nothing is built
or loaded when this module is imported.

A missing ``nvcc`` is an error: the kernel wrappers call ``lib()`` only for
CUDA tensors, and there is no fallback for those.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# IEEE float semantics: no --use_fast_math (sinf, cosf, sqrtf, division and
# powf stay correctly rounded or within their documented ulps), and no
# contraction of a*b+c into FMAs (--fmad=false): each operation rounds as
# in the plain torch versions, so a grazing occlusion test decides the same
# way on both.  With FMAs, 0.999863 of a 40-sample chunk's pixel-channels
# agreed with the plain version within 1e-4 on an H100, against 0.9999.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_PTR = ctypes.c_void_p  # every pointer and the stream: a 64-bit address
_INT = ctypes.c_int
# C entry point -> (source in csrc/, argument types); each returns an int
_SIGNATURES = {
    # (out, n, k0, k1, stream)
    "crt_philox_uniform": ("philox.cu", (_PTR, ctypes.c_int64,
                                         ctypes.c_uint32, ctypes.c_uint32,
                                         _PTR)),
    # (u, px, scal_f, out, P, lc, n_valid, ns, npl, egid, phong,
    #  atten_kind, n_scal, stream)
    "crt_fused_shadow_chunk": ("fused_shadow.cu",
                               (_PTR,) * 4 + (_INT,) * 9 + (_PTR,)),
    # (o, d, lo, hi, count_max_dist or NULL, cids, entry, spill, R, K,
    #  V_total, col0, V, cluster, warps, slice, stream)
    "crt_visit_order": ("visit_order.cu", (_PTR,) * 8 + (_INT,) * 8 + (_PTR,)),
    # (origin, cids, ok, d, md, ex, blk, slot or NULL, blocked_in, counts_in
    #  or NULL, blocked_out, counts_out or NULL, P, V, n_steps, S, F, C,
    #  gid0, n_slots, stream)
    "crt_union_sweep": ("union_sweep.cu", (_PTR,) * 12 + (_INT,) * 8
                        + (_PTR,)),
    # the roofline probes (tools/roofline.py): (x, y, n, stream),
    # (x, y, n, k, op, stream), (tbl, idx_in, idx_out, sums or NULL, R,
    # width, stream)
    "crt_roofline_stream": ("roofline.cu", (_PTR, _PTR, ctypes.c_int64,
                                            _PTR)),
    "crt_roofline_chain": ("roofline.cu", (_PTR, _PTR, ctypes.c_int64,
                                           _INT, _INT, _PTR)),
    "crt_roofline_gather": ("roofline.cu", (_PTR,) * 4 + (ctypes.c_int64,
                                                          _INT, _PTR)),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of c_raytracer_tpu_torch cannot be built")


def sources() -> list[str]:
    """The kernel sources, one library each."""
    return sorted({src for src, _ in _SIGNATURES.values()})


def library_path(source: str) -> str:
    """Where the library of ``source`` (a file name in csrc/) is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(_CSRC, source), "rb") as f:
        h.update(source.encode() + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libcrt_{stem}_{h.hexdigest()[:16]}.so")


def build() -> dict[str, str]:
    """Compile every library that is missing for the current sources, all
    compilers at once; returns {source: library path}."""
    paths = {src: library_path(src) for src in sources()}
    missing = {src: p for src, p in paths.items() if not os.path.exists(p)}
    if missing:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src, path in missing.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[src] = (tmp, path, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, (tmp, path, proc) in procs.items():
            try:
                out, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src} (nvcc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def lib() -> types.SimpleNamespace:
    """The kernels' C entry points, by name (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handles = {src: ctypes.CDLL(path)
                       for src, path in build().items()}
            fns = {}
            for name, (src, argtypes) in _SIGNATURES.items():
                fn = getattr(handles[src], name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
